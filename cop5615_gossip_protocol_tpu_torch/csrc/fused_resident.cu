// Resident lattice push-sum and gossip chunks, for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of the JAX package's two resident
// lattice tiers: ops/fused.py make_pushsum_chunk (pallas_call at :741) and
// make_gossip_chunk (:993), the whole-array tier (n <= 131,072), and
// ops/fused_stencil.py make_pushsum_stencil2_chunk (:268) and
// make_gossip_stencil2_chunk (:427), the tiled tier (any alignment, state
// planes up to its 100 MB budget). Both tiers compute the function of
// csrc/fused_stencil.cu, K synchronous rounds on one of the six arithmetic
// lattices:
//
//   d(i)     = the slot-th live direction of sender i, slot =
//              threefry(k1, k2, i) % degree(i)        (csrc/stencil.cuh)
//   inbox[j] = sum over the sorted displacement classes c, from 0.0, of
//              send[i] * [d(i) == class c]  with i = j - d_c mod n
//
// then the absorb with the term/conv latch (push-sum) or the receipt count
// with receiver-side suppression (gossip), stopping once the converged
// count reaches the target. Pad lanes (j >= n) and degree-0 nodes never
// send; pad lanes never receive. The split of the two tiers is the TPU's
// VMEM budget; here one kernel pair serves both, and the ladder still
// names the JAX tier.
//
// What bounds it on this card: launches and grid barriers, not bytes. The
// TPU tiers exist because a round at these sizes is dispatch-bound, and so
// is the streaming kernel pair here (two launches a round, a few µs each).
// The state is small: at the tiled tier's largest populations (2^20 padded
// nodes) push-sum's ping/pong planes and the int8 mark plane are 34 MB, so
// they stay in the 50 MB L2 from round to round. The arithmetic is one
// 20-round Threefry, the direction select and one compare per class a node.
//
// Design: one persistent cooperative launch runs every round of the chunk.
// Its grid is as many blocks as the SMs hold at once (never more than the
// nodes need), so all blocks are resident and may wait for each other; the
// launch goes through cudaLaunchCooperativeKernel, which refuses a grid
// that is not. Each round is two phases over ping/pong planes A and B,
// separated by grid barriers:
//   mark   - each sender draws its word at its global index j, picks its
//            direction and writes the class index of that displacement
//            (int8, -1 for no send; gossip folds in the active flag);
//   barrier;
//   absorb - each receiver gathers, per class in ascending order, the send
//            of its class source whose mark is that class, reading the
//            round's current planes, and writes the absorbed state to the
//            other planes; each block adds its converged count into the
//            round's slot of `scratch`;
//   barrier - then every block reads the same total and makes the same
//            choice: stop at the target or at the cap, else go on. No
//            block leaves the round loop alone, so no barrier waits on a
//            block that has left.
// The parity of the executed-round count lives in a register and names the
// current planes; block 0 writes it to `ctrl` once, at the end. The init
// and finish launches of csrc/chunk.cuh bracket the persistent launch as
// they do the streaming kernels, so a chunk is 3 launches whatever K is.
// A chunk from a converged state: the init launch sets the done flag, and
// every block of the persistent launch reads it at entry and leaves.
//
// The barrier is written here rather than taken from cooperative_groups,
// whose grid sync may need relocatable device code and so other build
// flags than the rest of the port's kernels: an arrival counter in global
// memory that only grows, with a fence before each arrival and after each
// wait. The k-th barrier of the launch waits for k * gridDim.x arrivals.
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
using gossip::grid_for;
using gossip::kBlock;
using gossip::mark_of;

// Waits until `target` arrivals have reached *arrived, counting this
// block's. Every thread's earlier writes are visible to every thread of
// the grid after it returns.
__device__ __forceinline__ void grid_barrier(unsigned* arrived,
                                             unsigned target) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(arrived, 1u);
    while (*(volatile unsigned*)arrived < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// The converged total of a round, read by every block after the barrier
// that follows the last addition to it.
__device__ __forceinline__ int round_total(const int* total) {
  return *(const volatile int*)total;
}

// ---------------------------------------------------------------- push-sum

__global__ void pushsum_rounds(PushSumPlanes a, PushSumPlanes b, int8_t* mark,
                               const long long* keys, gossip::Lattice L,
                               Classes cls, int n_pad, int rounds, float delta,
                               int term_rounds, int target, int* totals,
                               unsigned* arrived, int* ctrl) {
  // The init launch's verdict: every block reads the same value.
  if (ctrl[0]) return;
  const int n = L.n;
  unsigned barriers = 0;
  int executed = 0;
  bool done = false;
  while (!done && executed < rounds) {
    const bool odd = executed & 1;
    const PushSumPlanes cur = odd ? b : a;
    const PushSumPlanes nxt = odd ? a : b;
    const long long* key = keys + 2 * executed;
    for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
         j += gridDim.x * kBlock)
      mark[j] = j < n ? mark_of(L, cls, key, j) : (int8_t)-1;
    grid_barrier(arrived, ++barriers * gridDim.x);
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
    const int block_count = block_sum(c);
    if (threadIdx.x == 0) atomicAdd(totals + executed, block_count);
    grid_barrier(arrived, ++barriers * gridDim.x);
    done = round_total(totals + executed) >= target;
    ++executed;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctrl[0] = done ? 1 : 0;
    ctrl[1] = executed;
  }
}

// ------------------------------------------------------------------ gossip

__global__ void gossip_rounds(GossipPlanes a, GossipPlanes b, int8_t* mark,
                              const long long* keys, gossip::Lattice L,
                              Classes cls, int n_pad, int rounds,
                              int rumor_target, int suppress, int target,
                              int* totals, unsigned* arrived, int* ctrl) {
  if (ctrl[0]) return;
  const int n = L.n;
  unsigned barriers = 0;
  int executed = 0;
  bool done = false;
  while (!done && executed < rounds) {
    const bool odd = executed & 1;
    const GossipPlanes cur = odd ? b : a;
    const GossipPlanes nxt = odd ? a : b;
    const long long* key = keys + 2 * executed;
    for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
         j += gridDim.x * kBlock) {
      const bool sending = j < n && cur.active[j] != 0;
      mark[j] = sending ? mark_of(L, cls, key, j) : (int8_t)-1;
    }
    grid_barrier(arrived, ++barriers * gridDim.x);
    int c = 0;
    for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
         j += gridDim.x * kBlock) {
      const bool pad = j >= n;
      const int inbox = pad ? 0 : gossip::gossip_inbox(cls, mark, j, n);
      c += gossip::gossip_absorb_node(cur, nxt, j, pad, inbox, rumor_target,
                                      suppress);
    }
    const int block_count = block_sum(c);
    if (threadIdx.x == 0) atomicAdd(totals + executed, block_count);
    grid_barrier(arrived, ++barriers * gridDim.x);
    done = round_total(totals + executed) >= target;
    ++executed;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctrl[0] = done ? 1 : 0;
    ctrl[1] = executed;
  }
}

// Blocks of the persistent launch of `kernel` over n_pad nodes: as many as
// the SMs hold at once, at most one per 256 nodes. Unlike grid_for there
// is no guess when a query fails: the error is returned, and so is the
// lack of cooperative launch support or a round count whose barriers
// (2 * rounds * grid arrivals) would overflow the 32-bit counter.
template <typename Kernel>
cudaError_t cooperative_grid(Kernel kernel, int n_pad, int rounds, int device,
                             int* grid) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock,
                                                      0);
  if (err != cudaSuccess) return err;
  if (sms <= 0 || per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
  const long long want = ((long long)n_pad + kBlock - 1) / kBlock;
  const long long cap = (long long)sms * per_sm;
  *grid = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  if (2LL * rounds * *grid >= (1LL << 32)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Both entry points queue three launches on `stream` of CUDA device
// `device` (the init launch, the persistent cooperative launch that runs
// every round, the finish launch) and return the first error (a
// cudaError_t), 0 if none. The arguments are those of
// csrc/fused_stencil.cu's entry points: outputs and scratch are allocated
// by the caller, the A planes receive the result, the B planes are the
// other half of the ping/pong pair; mark is int8[n_pad]; ctrl is int32[2]
// (done, rounds executed); `classes` is a host array of the n_classes
// sorted displacement classes. scratch is int32[2 * (rounds + 2)], zeroed:
// the per-round totals and the init launch's total (rounds + 1 words), the
// init launch's ticket at word 2 * rounds + 1, and the barrier's arrival
// counter at word 2 * (rounds + 1).

extern "C" int gossip_pushsum_resident_chunk(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* s_b, float* w_b, int* term_b,
    int* conv_b, int8_t* mark, const long long* keys, int* ctrl, int* scratch,
    const int* classes, int n_classes, int kind, int n, int extra_node,
    int n_pad, int rounds, float delta, int term_rounds, int target,
    int device, void* stream_ptr) {
  gossip::Lattice L;
  Classes cls;
  if (rounds < 0 ||
      !gossip::setup_lattice(kind, n, extra_node, classes, n_classes, &L, &cls))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  err = cooperative_grid(pushsum_rounds, n_pad, rounds, device, &grid);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  unsigned* arrived = (unsigned*)(scratch + 2 * (rounds + 1));
  PushSumPlanes a{s, w, term, conv};
  PushSumPlanes b{s_b, w_b, term_b, conv_b};
  gossip::pushsum_init<<<grid_for(gossip::pushsum_init, n_pad, device), kBlock,
                         0, stream>>>(s0, w0, t0, c0, a, n_pad, totals + rounds,
                                      tickets + rounds, ctrl, target);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a,     &b,      &mark,  &keys,        &L,
                  &cls,   &n_pad,  &rounds, &delta,      &term_rounds,
                  &target, &totals, &arrived, &ctrl};
  err = cudaLaunchCooperativeKernel((const void*)pushsum_rounds, grid, kBlock,
                                    args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  gossip::pushsum_finish<<<grid_for(gossip::pushsum_finish, n_pad, device),
                           kBlock, 0, stream>>>(a, b, n_pad, ctrl);
  return (int)cudaGetLastError();
}

extern "C" int gossip_gossip_resident_chunk(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int* count_b, int* active_b, int* conv_b, int8_t* mark,
    const long long* keys, int* ctrl, int* scratch, const int* classes,
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
  int grid = 0;
  err = cooperative_grid(gossip_rounds, n_pad, rounds, device, &grid);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  unsigned* arrived = (unsigned*)(scratch + 2 * (rounds + 1));
  GossipPlanes a{count, active, conv};
  GossipPlanes b{count_b, active_b, conv_b};
  gossip::gossip_init<<<grid_for(gossip::gossip_init, n_pad, device), kBlock,
                        0, stream>>>(n0, a0, c0, a, n_pad, totals + rounds,
                                     tickets + rounds, ctrl, target);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a,           &b,        &mark,   &keys,   &L,
                  &cls,         &n_pad,    &rounds, &rumor_target,
                  &suppress,    &target,   &totals, &arrived, &ctrl};
  err = cudaLaunchCooperativeKernel((const void*)gossip_rounds, grid, kBlock,
                                    args, 0, stream);
  if (err != cudaSuccess) return (int)err;
  gossip::gossip_finish<<<grid_for(gossip::gossip_finish, n_pad, device),
                          kBlock, 0, stream>>>(a, b, n_pad, ctrl);
  return (int)cudaGetLastError();
}
