// Streaming lattice push-sum and gossip chunks, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's
// ops/fused_stencil_hbm.py: make_pushsum_stencil_hbm_chunk (pallas_call at
// :899) and make_gossip_stencil_hbm_chunk (pallas_call at :1206). Each runs
// K synchronous rounds of the protocol on one of the six arithmetic
// lattices (torus3d, ring, grid2d, grid3d, line, ref2d) on the padded
// [rows, 128] layout:
//
//   d(i)     = the slot-th live direction of sender i, slot =
//              threefry(k1, k2, i) % degree(i)        (csrc/stencil.cuh)
//   inbox[j] = sum over the sorted displacement classes c, from 0.0, of
//              send[i] * [d(i) == class c]  with i = j - d_c mod n
//
// then the absorb with the term/conv latch (push-sum) or the receipt count
// with receiver-side suppression (gossip), and a done flag that stops the
// chunk once the converged count reaches the target. Pad lanes (j >= n)
// and degree-0 nodes never send; pad lanes never receive.
//
// What bounds it on this card: memory traffic. A round must read and write
// the state (push-sum 16 bytes a node each way, gossip 12), and at 16.8M
// nodes that is 268 MB of push-sum state, five times the 50 MB L2, so it
// streams from HBM every round. The arithmetic is one 20-round Threefry,
// a lookup in the node's directions word and one compare per class a node.
//
// Design: the TPU kernel keeps the marked-displacement plane out of HBM by
// regenerating each sender's draw inside every window that reads it, and
// keeps state in ping/pong planes with mirrored margins. Here a shifted
// read is a load at a computed index that neighbouring threads make on
// neighbouring addresses, and the class windows of one block (+-1, +-g,
// +-g*g nodes) lie within a few hundred KB, so they are L2 hits. A chunk
// is one launch a round after a prologue, over ping/pong state planes A
// and B and two int8 mark planes, mark[0] and mark[1]:
//   prologue - each sender writes its round-0 mark into mark[0]: the class
//              index of its draw, read through its static directions word
//              (csrc/shard.cuh word_mark; -1 for no send; gossip only from
//              active nodes);
//   round j  - each receiver gathers, per class, the send of its class
//              source whose mark in mark[j & 1] is that class, reading the
//              round's current planes, and writes the absorbed state to
//              the other planes and, unless j is the chunk's last round,
//              its own round j + 1 mark into mark[(j + 1) & 1] (in gossip
//              from the active flag it has just computed); the block counts
//              converged nodes and the last block to finish latches the
//              done flag and the executed-round count in `ctrl`.
// Marks are double-buffered by round parity: round j writes the plane that
// round j - 1 read, and the launch boundary between them orders the two.
// The directions word (ops/fused_stencil_hbm.dir_words, 4 bytes a node,
// built once per layout on the host) replaces the per-round derivation of
// each node's live directions (three divisions by the cube side, the
// degree, the slot select and the class lookup); the hash stays. The two
// mark planes make the gather race-free without send planes: the halved
// send is recomputed from the sender's current s, w. An init launch copies
// the input planes into A and seeds the done flag from the incoming conv
// plane; a finish launch copies B into A when the chunk executed an odd
// number of rounds, so the result is always in A. Every launch first reads
// the done flag and returns at once when it is set (csrc/chunk.cuh), so a
// chunk of K rounds is K + 3 launches queued with no host sync. The grid
// is as many blocks of the round kernel as the SMs hold at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once a device),
// for every launch of the chunk, with grid-stride loops: a grid of fixed
// blocks larger than that would run a second, mostly idle wave, and a
// no-op launch stays a few µs. The class loops are unrolled to
// the class cap, so the class list stays in registers and a receiver's
// mark loads are all in flight at once.
//
// Global termination (the JAX push-sum kernel's global_term,
// ops/fused_stencil_hbm.py:575, :772-784, :837-853): a template flag G picks
// the round kernel's global instance, so the fault-free one keeps its code.
// Under G term and conv stay, the round counts the real nodes whose ratio
// moved more than delta * max(|s/w|, 1) (csrc/faults.cuh unstable_global),
// the round with none sets the done flag, and the finish launch latches
// conv on every real node of the result (csrc/chunk.cuh
// pushsum_finish_latch). The drop gate and crash-stop demote the JAX tier
// to the chunked engine, and the port's ladder does the same.//
// Numerics: built without fast math, with -fmad=false and denormals kept;
// the halve happens before the class sums, and the sums run from 0.0 in
// ascending class order, as the chunked engine's halve_and_send and
// deliver_stencil do, so push-sum is bitwise the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "shard.cuh"
#include "stencil.cuh"

namespace {

using gossip::Classes;
using gossip::GossipPlanes;
using gossip::PushSumPlanes;
using gossip::block_sum;
using gossip::finish_count;
using gossip::finish_verdict;
using gossip::round_grid;
using gossip::kBlock;
using gossip::word_mark;

// Round 0's marks into mark[0] under the round's key; `active` is the A
// planes' active flags (gossip) or null (push-sum: every node of degree > 0
// sends). A chunk of no rounds has no key and writes none.
__global__ void stencil_prologue(int8_t* mark, const int* active,
                                 const int* __restrict__ dirs,
                                 const long long* key, int n_pad, int rounds,
                                 const int* __restrict__ ctrl) {
  if (ctrl[0] || rounds == 0) return;
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock)
    mark[j] = active == nullptr || active[j] != 0
                  ? word_mark(dirs[j], k0, k1, j)
                  : (int8_t)-1;
}

// ---------------------------------------------------------------- push-sum

// Round j: reads `cur` and `mark`, writes `nxt` and, unless it is null,
// `next` (round j + 1's marks under `key`, that round's key). G: global
// termination (see the header); G = false is the fault-free kernel.
template <bool G>
__global__ void pushsum_round(PushSumPlanes cur, PushSumPlanes nxt,
                              const int8_t* __restrict__ mark,
                              int8_t* __restrict__ next, const long long* key,
                              const int* __restrict__ dirs, Classes cls, int n,
                              int n_pad, float delta, int term_rounds,
                              int target, int* total, unsigned* ticket,
                              int* ctrl) {
  if (ctrl[0]) return;
  const uint32_t k0 = next ? (uint32_t)key[0] : 0u;
  const uint32_t k1 = next ? (uint32_t)key[1] : 0u;
  int c = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool pad = j >= n;
    float in_s = 0.0f, in_w = 0.0f;
    if (!pad) gossip::pushsum_inbox(cls, mark, cur.s, cur.w, j, n, in_s, in_w);
    // mark[j] < 0 on pad lanes and degree 0: those keep their mass.
    if constexpr (!G)
      c += gossip::pushsum_absorb_node(cur, nxt, j, pad, mark[j] >= 0, in_s,
                                       in_w, delta, term_rounds);
    else
      c += gossip::pushsum_absorb_global_node(cur, nxt, j, pad, mark[j] >= 0,
                                              in_s, in_w, delta);
    if (next) next[j] = word_mark(dirs[j], k0, k1, j);
  }
  if constexpr (!G)
    finish_count(block_sum(c), total, ticket, ctrl, target, true);
  else
    finish_verdict(block_sum(c), total, ticket, ctrl, target, nullptr, true);
}

// ------------------------------------------------------------------ gossip

__global__ void gossip_round(GossipPlanes cur, GossipPlanes nxt,
                             const int8_t* __restrict__ mark,
                             int8_t* __restrict__ next, const long long* key,
                             const int* __restrict__ dirs, Classes cls, int n,
                             int n_pad, int rumor_target, int suppress,
                             int target, int* total, unsigned* ticket,
                             int* ctrl) {
  if (ctrl[0]) return;
  const uint32_t k0 = next ? (uint32_t)key[0] : 0u;
  const uint32_t k1 = next ? (uint32_t)key[1] : 0u;
  int c = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool pad = j >= n;
    const int inbox = pad ? 0 : gossip::gossip_inbox(cls, mark, j, n);
    int cnt, act;
    const int cv = gossip::gossip_absorb(
        [&] { return cur.conv[j] != 0; }, [&] { return cur.count[j]; },
        [&] { return cur.active[j]; }, pad, inbox, rumor_target, suppress, cnt,
        act);
    nxt.count[j] = cnt;
    nxt.active[j] = act;
    nxt.conv[j] = cv;
    if (next) next[j] = act ? word_mark(dirs[j], k0, k1, j) : (int8_t)-1;
    c += cv;
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, true);
}

// Round r's planes and marks: it reads plane set r % 2 (A first) and
// mark[r % 2], writes the other set and round r + 1's marks into
// mark[(r + 1) % 2], none after the chunk's last round.
template <typename Planes>
void round_buffers(const Planes& a, const Planes& b, int8_t* mark, int n_pad,
                   int r, int rounds, Planes* cur, Planes* nxt,
                   int8_t** mk, int8_t** next) {
  *cur = (r & 1) ? b : a;
  *nxt = (r & 1) ? a : b;
  *mk = mark + (r & 1) * n_pad;
  *next = r + 1 < rounds ? mark + ((r + 1) & 1) * n_pad : nullptr;
}

int pushsum_grid_cache[2][64];
int gossip_grid_cache[64];

// Zeroes a chunk's control words: ctrl (int32[2]) and the 8 * (rounds + 2)
// bytes of scratch behind it, in one memset.
cudaError_t zero_control(int* ctrl, int rounds, cudaStream_t stream) {
  return cudaMemsetAsync(ctrl, 0, 8 * ((size_t)rounds + 3), stream);
}

// Queues a push-sum chunk's launches after the control words' memset:
// init, the prologue, one round launch of instance G a round, finish (with
// the global verdict's latch under G).
template <bool G>
cudaError_t queue_pushsum(const float* s0, const float* w0, const int* t0,
                          const int* c0, PushSumPlanes a, PushSumPlanes b,
                          int8_t* mark, const long long* keys, const int* dirs,
                          int* ctrl, Classes cls, int n, int n_pad, int rounds,
                          float delta, int term_rounds, int target, int device,
                          cudaStream_t stream) {
  int* totals = ctrl + 2;
  unsigned* tickets = (unsigned*)(totals + rounds + 1);
  // Every launch of the chunk on the round kernel's grid, whose capacity
  // (the lowest of the four) is asked once a device.
  const int grid = round_grid(pushsum_round<G>, n_pad, device,
                             pushsum_grid_cache[G ? 1 : 0]);
  gossip::pushsum_init<<<grid, kBlock, 0, stream>>>(
      s0, w0, t0, c0, a, n_pad, totals + rounds, tickets + rounds, ctrl,
      target);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stencil_prologue<<<grid, kBlock, 0, stream>>>(
      mark, nullptr, dirs, keys, n_pad, rounds, ctrl);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    PushSumPlanes cur, nxt;
    int8_t *mk, *next;
    round_buffers(a, b, mark, n_pad, r, rounds, &cur, &nxt, &mk, &next);
    pushsum_round<G><<<grid, kBlock, 0, stream>>>(
        cur, nxt, mk, next, keys + 2 * (r + 1), dirs, cls, n, n_pad, delta,
        term_rounds, target, totals + r, tickets + r, ctrl);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  if constexpr (G)
    gossip::pushsum_finish_latch<<<grid, kBlock, 0, stream>>>(a, b, n, n_pad,
                                                              ctrl);
  else
    gossip::pushsum_finish<<<grid, kBlock, 0, stream>>>(a, b, n_pad, ctrl);
  return cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Both entry points zero the control words and queue the init launch, the
// prologue, one launch a round and the finish launch on `stream` of CUDA
// device `device`, and return the first error (a cudaError_t), 0 if none.
// Outputs and control words are allocated by the caller: the A planes
// receive the result, the B planes are the other half of the ping/pong
// pair; mark is int8[2 * n_pad]; dirs is int32[n_pad], every slot's
// directions word (ops/fused_stencil_hbm.dir_words); ctrl holds int32[2]
// (done, rounds executed), then 8 * (rounds + 2) bytes of scratch, of which
// the per-round totals and then the tickets (int32[rounds + 1] each) are
// used. `classes` is a host array of the n_classes sorted displacement
// classes. The push-sum entry point's `global` picks global termination's
// instances.

extern "C" int gossip_pushsum_stencil_chunk(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* s_b, float* w_b, int* term_b,
    int* conv_b, int8_t* mark, const long long* keys, const int* dirs,
    int* ctrl, const int* classes, int n_classes, int kind, int n,
    int extra_node, int n_pad, int rounds, float delta, int term_rounds,
    int target, int global, int device, void* stream_ptr) {
  gossip::Lattice L;
  Classes cls;
  if (rounds < 0 ||
      !gossip::setup_lattice(kind, n, extra_node, classes, n_classes, &L, &cls))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const PushSumPlanes a{s, w, term, conv};
  const PushSumPlanes b{s_b, w_b, term_b, conv_b};
  // The control words, zeroed on the stream ahead of the chunk.
  err = zero_control(ctrl, rounds, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)(global ? queue_pushsum<true>(s0, w0, t0, c0, a, b, mark, keys,
                                            dirs, ctrl, cls, n, n_pad, rounds,
                                            delta, term_rounds, target, device,
                                            stream)
                      : queue_pushsum<false>(s0, w0, t0, c0, a, b, mark, keys,
                                             dirs, ctrl, cls, n, n_pad, rounds,
                                             delta, term_rounds, target, device,
                                             stream));
}

extern "C" int gossip_gossip_stencil_chunk(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int* count_b, int* active_b, int* conv_b, int8_t* mark,
    const long long* keys, const int* dirs, int* ctrl, const int* classes,
    int n_classes, int kind, int n, int extra_node, int n_pad, int rounds,
    int rumor_target, int suppress, int target, int device,
    void* stream_ptr) {
  gossip::Lattice L;
  Classes cls;
  if (rounds < 0 ||
      !gossip::setup_lattice(kind, n, extra_node, classes, n_classes, &L, &cls))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = ctrl + 2;
  unsigned* tickets = (unsigned*)(totals + rounds + 1);
  const GossipPlanes a{count, active, conv};
  const GossipPlanes b{count_b, active_b, conv_b};
  // Every launch of the chunk on the round kernel's grid, whose capacity
  // (the lowest of the four) is asked once a device.
  const int grid =
      round_grid(gossip_round, n_pad, device, gossip_grid_cache);
  // The control words, zeroed on the stream ahead of the chunk.
  err = zero_control(ctrl, rounds, stream);
  if (err != cudaSuccess) return (int)err;
  gossip::gossip_init<<<grid, kBlock, 0, stream>>>(
      n0, a0, c0, a, n_pad, totals + rounds, tickets + rounds, ctrl, target);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  stencil_prologue<<<grid, kBlock, 0, stream>>>(
      mark, active, dirs, keys, n_pad, rounds, ctrl);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    GossipPlanes cur, nxt;
    int8_t *mk, *next;
    round_buffers(a, b, mark, n_pad, r, rounds, &cur, &nxt, &mk, &next);
    gossip_round<<<grid, kBlock, 0, stream>>>(
        cur, nxt, mk, next, keys + 2 * (r + 1), dirs, cls, n, n_pad,
        rumor_target, suppress, target, totals + r, tickets + r, ctrl);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  gossip::gossip_finish<<<grid, kBlock, 0, stream>>>(a, b, n_pad, ctrl);
  return (int)cudaGetLastError();
}
