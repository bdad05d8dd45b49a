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
// the direction select and one compare per class a node.
//
// Design: the TPU kernel keeps the marked-displacement plane out of HBM by
// regenerating each sender's draw inside every window that reads it, and
// keeps state in ping/pong planes with mirrored margins. Here a shifted
// read is a load at a computed index that neighbouring threads make on
// neighbouring addresses, and the class windows of one block (+-1, +-g,
// +-g*g nodes) lie within a few hundred KB, so they are L2 hits. Each
// round is two launches over ping/pong state planes A and B:
//   mark   - each sender draws its word at its global index j, picks its
//            direction and writes the class index of that displacement
//            (int8, -1 for no send; gossip folds in the active flag);
//   absorb - each receiver gathers, per class, the send of its class
//            source whose mark is that class, reading the round's
//            current planes, and writes the absorbed state to the other
//            planes; the block counts converged nodes and the last block
//            to finish latches the done flag and the executed-round count
//            in `ctrl` (its parity says which planes are current).
// Marking once per sender costs one int8 plane (2 bytes a node a round)
// against recomputing each neighbour's draw in the receiver (1 + up to 10
// hashes a node). The two planes make the gather race-free without send
// planes: the halved send is recomputed from the sender's current s, w.
// An init launch copies the input planes into A and seeds the done flag
// from the incoming conv plane; a finish launch copies B into A when the
// chunk executed an odd number of rounds, so the result is always in A.
// Every mark/absorb launch first reads the done flag and returns at once
// when it is set (csrc/chunk.cuh), so a chunk of K rounds is 2K + 2
// launches queued with no host sync. Each grid is as many blocks as
// the SMs hold at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// with grid-stride loops: a grid of fixed blocks larger than that would
// run a second, mostly idle wave, and a no-op launch stays a few µs. The
// class loops are unrolled to the class cap, so the class list stays in
// registers and a receiver's mark loads are all in flight at once.
//
// Numerics: built without fast math, with -fmad=false and denormals kept;
// the halve happens before the class sums, and the sums run from 0.0 in
// ascending class order, as the chunked engine's halve_and_send and
// deliver_stencil do, so push-sum is bitwise the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "stencil.cuh"

namespace {

using gossip::Classes;
using gossip::GossipPlanes;
using gossip::PushSumPlanes;
using gossip::block_sum;
using gossip::finish_count;
using gossip::grid_for;
using gossip::kBlock;
using gossip::mark_of;

// ---------------------------------------------------------------- push-sum

__global__ void pushsum_mark(int8_t* mark, const long long* __restrict__ key,
                             gossip::Lattice L, Classes cls, int n_pad,
                             const int* __restrict__ ctrl) {
  if (ctrl[0]) return;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    mark[j] = j < L.n ? mark_of(L, cls, key, j) : (int8_t)-1;
  }
}

__global__ void pushsum_absorb(PushSumPlanes a, PushSumPlanes b,
                               const int8_t* __restrict__ mark, Classes cls,
                               int n, int n_pad, float delta, int term_rounds,
                               int target, int* total, unsigned* ticket,
                               int* ctrl) {
  if (ctrl[0]) return;
  const bool odd = ctrl[1] & 1;
  const PushSumPlanes cur = odd ? b : a;
  const PushSumPlanes nxt = odd ? a : b;
  int c = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool pad = j >= n;
    float in_s = 0.0f, in_w = 0.0f;
    if (!pad) gossip::pushsum_inbox(cls, mark, cur.s, cur.w, j, n, in_s, in_w);
    // mark[j] < 0 on pad lanes and degree 0: those keep their mass.
    c += gossip::pushsum_absorb_node(cur, nxt, j, pad, mark[j] >= 0, in_s,
                                     in_w, delta, term_rounds);
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, true);
}

// ------------------------------------------------------------------ gossip

__global__ void gossip_mark(GossipPlanes a, GossipPlanes b, int8_t* mark,
                            const long long* __restrict__ key,
                            gossip::Lattice L, Classes cls, int n_pad,
                            const int* __restrict__ ctrl) {
  if (ctrl[0]) return;
  const int* active = (ctrl[1] & 1) ? b.active : a.active;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool sending = j < L.n && active[j] != 0;
    mark[j] = sending ? mark_of(L, cls, key, j) : (int8_t)-1;
  }
}

__global__ void gossip_absorb(GossipPlanes a, GossipPlanes b,
                              const int8_t* __restrict__ mark, Classes cls,
                              int n, int n_pad, int rumor_target, int suppress,
                              int target, int* total, unsigned* ticket,
                              int* ctrl) {
  if (ctrl[0]) return;
  const bool odd = ctrl[1] & 1;
  const GossipPlanes cur = odd ? b : a;
  const GossipPlanes nxt = odd ? a : b;
  int c = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool pad = j >= n;
    const int inbox = pad ? 0 : gossip::gossip_inbox(cls, mark, j, n);
    c += gossip::gossip_absorb_node(cur, nxt, j, pad, inbox, rumor_target,
                                    suppress);
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, true);
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Both entry points queue the init launch, two launches per round and the
// finish launch on `stream` of CUDA device `device`, and return the first
// launch error (a cudaError_t), 0 if none. Outputs and scratch are
// allocated by the caller: the A planes receive the result, the B planes
// are the other half of the ping/pong pair; mark is int8[n_pad]; ctrl is
// int32[2] (done, rounds executed) and scratch int32[2 * (rounds + 1)]
// (per-round totals, then tickets), both zeroed. `classes` is a host array
// of the n_classes sorted displacement classes.

extern "C" int gossip_pushsum_stencil_chunk(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* s_b, float* w_b, int* term_b,
    int* conv_b, int8_t* mark, const long long* keys, int* ctrl, int* scratch,
    const int* classes, int n_classes, int kind, int n, int extra_node,
    int n_pad, int rounds, float delta, int term_rounds, int target,
    int device, void* stream_ptr) {
  gossip::Lattice L;
  Classes cls;
  if (!gossip::setup_lattice(kind, n, extra_node, classes, n_classes, &L, &cls))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  const PushSumPlanes a{s, w, term, conv};
  const PushSumPlanes b{s_b, w_b, term_b, conv_b};
  const int grid_init = grid_for(gossip::pushsum_init, n_pad, device);
  const int grid_mark = grid_for(pushsum_mark, n_pad, device);
  const int grid_absorb = grid_for(pushsum_absorb, n_pad, device);
  const int grid_finish = grid_for(gossip::pushsum_finish, n_pad, device);
  gossip::pushsum_init<<<grid_init, kBlock, 0, stream>>>(
      s0, w0, t0, c0, a, n_pad, totals + rounds, tickets + rounds, ctrl,
      target);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    pushsum_mark<<<grid_mark, kBlock, 0, stream>>>(mark, keys + 2 * r, L,
                                                   cls, n_pad, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    pushsum_absorb<<<grid_absorb, kBlock, 0, stream>>>(
        a, b, mark, cls, n, n_pad, delta, term_rounds, target, totals + r,
        tickets + r, ctrl);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  gossip::pushsum_finish<<<grid_finish, kBlock, 0, stream>>>(a, b, n_pad, ctrl);
  return (int)cudaGetLastError();
}

extern "C" int gossip_gossip_stencil_chunk(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int* count_b, int* active_b, int* conv_b, int8_t* mark,
    const long long* keys, int* ctrl, int* scratch, const int* classes,
    int n_classes, int kind, int n, int extra_node, int n_pad, int rounds,
    int rumor_target, int suppress, int target, int device,
    void* stream_ptr) {
  gossip::Lattice L;
  Classes cls;
  if (!gossip::setup_lattice(kind, n, extra_node, classes, n_classes, &L, &cls))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  const GossipPlanes a{count, active, conv};
  const GossipPlanes b{count_b, active_b, conv_b};
  const int grid_init = grid_for(gossip::gossip_init, n_pad, device);
  const int grid_mark = grid_for(gossip_mark, n_pad, device);
  const int grid_absorb = grid_for(gossip_absorb, n_pad, device);
  const int grid_finish = grid_for(gossip::gossip_finish, n_pad, device);
  gossip::gossip_init<<<grid_init, kBlock, 0, stream>>>(
      n0, a0, c0, a, n_pad, totals + rounds, tickets + rounds, ctrl, target);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    gossip_mark<<<grid_mark, kBlock, 0, stream>>>(a, b, mark, keys + 2 * r,
                                                  L, cls, n_pad, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    gossip_absorb<<<grid_absorb, kBlock, 0, stream>>>(
        a, b, mark, cls, n, n_pad, rumor_target, suppress, target, totals + r,
        tickets + r, ctrl);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  gossip::gossip_finish<<<grid_finish, kBlock, 0, stream>>>(a, b, n_pad, ctrl);
  return (int)cudaGetLastError();
}
