// imp2d/imp3d push-sum and gossip chunks under pooled long-range sampling,
// for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the JAX package:
// ops/fused_imp.py's make_pushsum_imp_chunk (pallas_call at :307) and
// make_gossip_imp_chunk (:467), and ops/fused_imp_hbm.py's
// make_pushsum_imp_hbm_chunk (:478) and make_gossip_imp_hbm_chunk (:716).
// The two pairs compute one function, split by the TPU's VMEM budget into
// a resident and a streaming tier; here one kernel pair over ping/pong
// device planes computes it at any size. Each chunk runs K synchronous
// rounds on the padded [rows, 128] pool layout:
//
//   class(i) = the lattice class word(i) picks with threefry(k1, k2, i),
//              or for its long-range slot L + its pool slot in the packed
//              word threefry(ck1, ck2, choice_counter(i))
//                                             (csrc/imp.cuh, imp_mark)
//   inbox[j] = sum from 0.0 over the L lattice classes q in sorted order,
//              then the P pool slots p, of send[i] * [class(i) == id],
//              i = j - d mod n, (id, d) = (q, d_q) or (L + p, offs[p])
//
// then the absorb with the term/conv latch (push-sum) or the receipt count
// with receiver-side suppression (gossip), and the done flag. Pad lanes
// (j >= n) never send and never receive; pool sources wrap mod n across
// the pad, lattice sources never leave the grid.
//
// What bounds it on this card: memory traffic. A round must read and write
// the state (push-sum 16 bytes a node each way, gossip 12); at 16.8M nodes
// that streams from HBM every round. The lattice class sources of a block
// lie within +-g*g nodes of it and hit the L2, but each of the P pool
// classes reads the marks and sends of a window a random distance away:
// P more streams of the mark plane (and of s and w, for push-sum) that the
// L2 serves only once per window. The arithmetic is a 20-round Threefry
// hash per node, a second one for a node that draws its long-range slot,
// the slot select and one compare per class a node.
//
// Design: as csrc/fused_stencil.cu, a chunk is one launch a round after a
// prologue, over ping/pong state planes A and B and two int8 mark planes,
// mark[0] and mark[1], with the init and finish launches of
// csrc/chunk.cuh:
//   prologue - round 0's marks into mark[0] (-1 for no send; gossip only
//              from active nodes);
//   round j  - each receiver gathers, per class, the halved send of its
//              class source whose mark in mark[j & 1] is that class,
//              reading the round's current planes, and writes the absorbed
//              state to the other planes and, unless j is the chunk's last
//              round, its own round j + 1 mark into mark[(j + 1) & 1] (in
//              gossip from the active flag it has just computed); the
//              block counts converged nodes and the last block to finish
//              latches the done flag and the executed-round count.
// Round j writes the mark plane that round j - 1 read, and the launch
// boundary between them orders the two. One thread a node, in a
// grid-stride sweep: the packed choice word (shared by 8 nodes 128 rows
// apart) is hashed only by a node whose slot comes out as the long-range
// one. Hashing it once for its 8 nodes, in a thread that takes all 8, costs
// the gossip round less but keeps 8 times the nodes in flight across the
// grid, and the push-sum gathers lose more L2 hits than the hashes save
// (scripts/imp_round_variants.py). A node's class is read through its
// static directions word (ops/fused_imp.imp_dir_words, 4 bytes a node,
// built on the card once per layout and device); deriving its live
// lattice directions in the pass instead (divisions by the grid side, the
// degree) measured slower (the same script). The class loops are
// unrolled to the caps (csrc/imp.cuh), so the class lists stay in
// registers and every class's mark load is in flight at once. Every launch
// of a chunk runs on the round kernel's grid, as many blocks as the SMs
// hold at once, asked once a device, with grid-stride loops; every launch
// first reads the done flag and returns at once when it is set, so a chunk
// of K rounds is K + 3 launches queued with no host sync. The TPU kernels'
// class-column planes, doubled planes, windows and d/d+Z blends exist
// because a TPU tile load needs a static shape; here the lattice is a
// word, a shifted read is a load at a computed index, and the round's pool
// offsets go in by value, one launch per round, from the host-drawn
// stream. Class ids, not displacements, key the delivery, so a pool offset
// equal to a lattice displacement (or to another slot's) delivers each
// send once.
//
// Global termination (the JAX push-sum kernels' global_term,
// ops/fused_imp.py:191, :274-287; ops/fused_imp_hbm.py:252, :397-450): a
// template flag G picks the push-sum round kernel's global instance, so the
// fault-free one keeps its code. Under G term and conv stay, the round
// counts the real nodes whose ratio moved more than delta * max(|s/w|, 1)
// (csrc/faults.cuh unstable_global), the round with none sets the done
// flag, and the finish launch latches conv on every real node of the
// result (csrc/chunk.cuh pushsum_finish_latch). Both JAX imp tiers demote
// the drop gate and crash-stop to the chunked engine, and so does the
// port's ladder.//
// Numerics: see csrc/chunk.cuh; the halve happens before the class sums,
// which run from 0.0 in class order, as the chunked engine's
// halve_and_send and deliver_imp_pool do, so push-sum is bitwise the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "imp.cuh"

namespace {

using gossip::Classes;
using gossip::GossipPlanes;
using gossip::ImpPool;
using gossip::PushSumPlanes;
using gossip::block_sum;
using gossip::finish_count;
using gossip::finish_verdict;
using gossip::kBlock;
using gossip::kChoiceLanes;
using gossip::kChoicePack;
using gossip::round_grid;

// The uint32 words of a device key pair; zeros when there is no key.
struct KeyWords {
  uint32_t a, b;
};

__device__ __forceinline__ KeyWords key_words(const long long* key) {
  return key ? KeyWords{(uint32_t)key[0], (uint32_t)key[1]} : KeyWords{0u, 0u};
}

// Round 0's marks into mark[0] under the round's key and choice key;
// `active` is the A planes' active flags (gossip) or null (push-sum: every
// real node sends). A chunk of no rounds has no key and writes none.
__global__ void imp_prologue(int8_t* mark, const int* active,
                             const uint32_t* __restrict__ words,
                             const long long* key, const long long* ckey,
                             int n, int n_pad, int pool_size,
                             int lattice_count, int rounds,
                             const int* __restrict__ ctrl) {
  if (ctrl[0] || rounds == 0) return;
  const KeyWords k = key_words(key), c = key_words(ckey);
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock)
    mark[j] = j < n && (active == nullptr || active[j] != 0)
                  ? gossip::imp_mark(words[j], k.a, k.b, c.a, c.b, j,
                                     pool_size, lattice_count)
                  : (int8_t)-1;
}

// ---------------------------------------------------------------- push-sum

// Round j: reads `cur` and `mark`, writes `nxt` and, unless it is null,
// `next` (round j + 1's marks under `key` and `ckey`, that round's keys).
// G: global termination (see the header); G = false is the fault-free
// kernel.
template <bool G>
__global__ void pushsum_round(PushSumPlanes cur, PushSumPlanes nxt,
                              const int8_t* __restrict__ mark,
                              int8_t* __restrict__ next, const long long* key,
                              const long long* ckey,
                              const uint32_t* __restrict__ words,
                              Classes lattice, ImpPool pool, int n, int n_pad,
                              float delta, int term_rounds, int target,
                              int* total, unsigned* ticket, int* ctrl) {
  if (ctrl[0]) return;
  const KeyWords k = key_words(next ? key : nullptr);
  const KeyWords c = key_words(next ? ckey : nullptr);
  int count = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool pad = j >= n;
    float in_s = 0.0f, in_w = 0.0f;
    if (!pad)
      gossip::imp_pushsum_inbox(lattice, pool, mark, cur.s, cur.w, j, n, in_s,
                                in_w);
    // mark[j] < 0 on pad lanes: those keep their mass.
    if constexpr (!G)
      count += gossip::pushsum_absorb_node(cur, nxt, j, pad, mark[j] >= 0, in_s,
                                           in_w, delta, term_rounds);
    else
      count += gossip::pushsum_absorb_global_node(cur, nxt, j, pad,
                                                  mark[j] >= 0, in_s, in_w,
                                                  delta);
    if (next)
      next[j] = pad ? (int8_t)-1
                    : gossip::imp_mark(words[j], k.a, k.b, c.a, c.b, j,
                                       pool.count, lattice.count);
  }
  if constexpr (!G)
    finish_count(block_sum(count), total, ticket, ctrl, target, true);
  else
    finish_verdict(block_sum(count), total, ticket, ctrl, target, nullptr, true);
}

// ------------------------------------------------------------------ gossip

__global__ void gossip_round(GossipPlanes cur, GossipPlanes nxt,
                             const int8_t* __restrict__ mark,
                             int8_t* __restrict__ next, const long long* key,
                             const long long* ckey,
                             const uint32_t* __restrict__ words,
                             Classes lattice, ImpPool pool, int n, int n_pad,
                             int rumor_target, int suppress, int target,
                             int* total, unsigned* ticket, int* ctrl) {
  if (ctrl[0]) return;
  const KeyWords k = key_words(next ? key : nullptr);
  const KeyWords c = key_words(next ? ckey : nullptr);
  int count = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool pad = j >= n;
    const int inbox =
        pad ? 0 : gossip::imp_gossip_inbox(lattice, pool, mark, j, n);
    int cnt, act;
    const int cv = gossip::gossip_absorb(
        [&] { return cur.conv[j] != 0; }, [&] { return cur.count[j]; },
        [&] { return cur.active[j]; }, pad, inbox, rumor_target, suppress, cnt,
        act);
    nxt.count[j] = cnt;
    nxt.active[j] = act;
    nxt.conv[j] = cv;
    if (next)
      next[j] = !pad && act ? gossip::imp_mark(words[j], k.a, k.b, c.a, c.b, j,
                                               pool.count, lattice.count)
                            : (int8_t)-1;
    count += cv;
  }
  finish_count(block_sum(count), total, ticket, ctrl, target, true);
}

// Lattice classes from the C arguments; false if they are out of range for
// the kernels.
bool setup(int n, int n_pad, const int* classes, int n_classes, int pool_size,
           int rounds, Classes* lattice) {
  if (n < 2 || n > n_pad || rounds < 0 ||
      n_pad % (kChoicePack * kChoiceLanes) != 0 || n_classes < 1 ||
      n_classes > gossip::kMaxDirs || pool_size < 2 ||
      pool_size > gossip::kMaxImpPool || (pool_size & (pool_size - 1)) != 0)
    return false;
  lattice->count = n_classes;
  for (int k = 0; k < gossip::kMaxClasses; ++k)
    lattice->d[k] = k < n_classes ? classes[k] : 0;
  for (int k = 0; k < n_classes; ++k)
    if (lattice->d[k] < 1 || lattice->d[k] >= n) return false;
  return true;
}

// Round r's pool from the host stream `offs` [rounds, pool_size]; false if
// an offset is outside [1, n-1].
bool round_pool(const int* offs, int r, int pool_size, int n, ImpPool* pool) {
  pool->count = pool_size;
  for (int p = 0; p < gossip::kMaxImpPool; ++p) {
    pool->d[p] = p < pool_size ? offs[r * pool_size + p] : 0;
    if (p < pool_size && (pool->d[p] < 1 || pool->d[p] >= n)) return false;
  }
  return true;
}

bool valid_pools(const int* offs, int rounds, int pool_size, int n) {
  ImpPool pool;
  for (int r = 0; r < rounds; ++r)
    if (!round_pool(offs, r, pool_size, n, &pool)) return false;
  return true;
}

// Round r's planes and marks: it reads plane set r % 2 (A first) and
// mark[r % 2], writes the other set and round r + 1's marks into
// mark[(r + 1) % 2], none after the chunk's last round.
template <typename Planes>
void round_buffers(const Planes& a, const Planes& b, int8_t* mark, int n_pad,
                   int r, int rounds, Planes* cur, Planes* nxt, int8_t** mk,
                   int8_t** next) {
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
                          int8_t* mark, const long long* keys,
                          const long long* ckeys, const uint32_t* words,
                          const int* offs, int* ctrl, Classes lattice, int n,
                          int n_pad, int rounds, int pool_size, float delta,
                          int term_rounds, int target, int device,
                          cudaStream_t stream) {
  int* totals = ctrl + 2;
  unsigned* tickets = (unsigned*)(totals + rounds + 1);
  // Every launch of the chunk on the round kernel's grid, whose capacity
  // is asked once a device.
  const int grid = round_grid(pushsum_round<G>, n_pad, device,
                             pushsum_grid_cache[G ? 1 : 0]);
  gossip::pushsum_init<<<grid, kBlock, 0, stream>>>(
      s0, w0, t0, c0, a, n_pad, totals + rounds, tickets + rounds, ctrl,
      target);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  imp_prologue<<<grid, kBlock, 0, stream>>>(mark, nullptr, words, keys, ckeys,
                                            n, n_pad, pool_size, lattice.count,
                                            rounds, ctrl);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    ImpPool pool;
    round_pool(offs, r, pool_size, n, &pool);
    PushSumPlanes cur, nxt;
    int8_t *mk, *next;
    round_buffers(a, b, mark, n_pad, r, rounds, &cur, &nxt, &mk, &next);
    pushsum_round<G><<<grid, kBlock, 0, stream>>>(
        cur, nxt, mk, next, keys + 2 * (r + 1), ckeys + 2 * (r + 1), words,
        lattice, pool, n, n_pad, delta, term_rounds, target, totals + r,
        tickets + r, ctrl);
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
// pair; mark is int8[2 * n_pad]; words is uint32[n_pad], every slot's
// directions word (ops/fused_imp.imp_dir_words); ctrl holds int32[2]
// (done, rounds executed), then 8 * (rounds + 2) bytes of scratch, of which
// the per-round totals and then the tickets (int32[rounds + 1] each) are
// used. `keys` and `ckeys` are device arrays of the per-round key pairs;
// `offs` ([rounds, pool_size]) and `classes` (the n_classes sorted lattice
// classes) are host arrays, read here. The push-sum entry point's `global`
// picks global termination's instances.

extern "C" int gossip_pushsum_imp_chunk(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* s_b, float* w_b, int* term_b,
    int* conv_b, int8_t* mark, const long long* keys, const long long* ckeys,
    const uint32_t* words, const int* offs, int* ctrl, const int* classes,
    int n_classes, int n, int n_pad, int rounds, int pool_size, float delta,
    int term_rounds, int target, int global, int device, void* stream_ptr) {
  Classes lattice;
  if (!setup(n, n_pad, classes, n_classes, pool_size, rounds, &lattice) ||
      !valid_pools(offs, rounds, pool_size, n))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const PushSumPlanes a{s, w, term, conv};
  const PushSumPlanes b{s_b, w_b, term_b, conv_b};
  err = zero_control(ctrl, rounds, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)(global
                   ? queue_pushsum<true>(s0, w0, t0, c0, a, b, mark, keys, ckeys,
                                         words, offs, ctrl, lattice, n, n_pad,
                                         rounds, pool_size, delta, term_rounds,
                                         target, device, stream)
                   : queue_pushsum<false>(s0, w0, t0, c0, a, b, mark, keys,
                                          ckeys, words, offs, ctrl, lattice, n,
                                          n_pad, rounds, pool_size, delta,
                                          term_rounds, target, device, stream));
}

extern "C" int gossip_gossip_imp_chunk(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int* count_b, int* active_b, int* conv_b, int8_t* mark,
    const long long* keys, const long long* ckeys, const uint32_t* words,
    const int* offs, int* ctrl, const int* classes, int n_classes, int n,
    int n_pad, int rounds, int pool_size, int rumor_target, int suppress,
    int target, int device, void* stream_ptr) {
  Classes lattice;
  if (!setup(n, n_pad, classes, n_classes, pool_size, rounds, &lattice) ||
      !valid_pools(offs, rounds, pool_size, n))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = ctrl + 2;
  unsigned* tickets = (unsigned*)(totals + rounds + 1);
  const GossipPlanes a{count, active, conv};
  const GossipPlanes b{count_b, active_b, conv_b};
  const int grid = round_grid(gossip_round, n_pad, device, gossip_grid_cache);
  err = zero_control(ctrl, rounds, stream);
  if (err != cudaSuccess) return (int)err;
  gossip::gossip_init<<<grid, kBlock, 0, stream>>>(
      n0, a0, c0, a, n_pad, totals + rounds, tickets + rounds, ctrl, target);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  imp_prologue<<<grid, kBlock, 0, stream>>>(mark, active, words, keys, ckeys,
                                            n, n_pad, pool_size, n_classes,
                                            rounds, ctrl);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    ImpPool pool;
    round_pool(offs, r, pool_size, n, &pool);
    GossipPlanes cur, nxt;
    int8_t *mk, *next;
    round_buffers(a, b, mark, n_pad, r, rounds, &cur, &nxt, &mk, &next);
    gossip_round<<<grid, kBlock, 0, stream>>>(
        cur, nxt, mk, next, keys + 2 * (r + 1), ckeys + 2 * (r + 1), words,
        lattice, pool, n, n_pad, rumor_target, suppress, target, totals + r,
        tickets + r, ctrl);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  gossip::gossip_finish<<<grid, kBlock, 0, stream>>>(a, b, n_pad, ctrl);
  return (int)cudaGetLastError();
}
