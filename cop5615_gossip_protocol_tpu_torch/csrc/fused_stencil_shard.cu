// Resident sharded lattice super-steps, push-sum and gossip, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's VMEM fused x sharded
// composition: parallel/fused_sharded.py make_stencil_shard_chunk
// (pallas_call at :448; one factory for both algorithms). One launch runs
// a super-step, up to CR synchronous rounds, on one shard's halo-extended
// buffer (csrc/shard.cuh):
//
//   mark[x]  = class index of the displacement sender x draws at its GLOBAL
//              flat index g(x) (threefry at g(x), the slot-th live direction
//              of the lattice at g(x), read from its static directions word;
//              csrc/shard.cuh), -1 for pad lanes, degree 0 and, in gossip,
//              inactive nodes;
//   inbox[x] = sum over the sorted classes k, from 0.0, of send[src] where
//              src = x - e (mod n_ext), e = e1[k] at g(x) >= d_k, else e2[k],
//              and mark[src] == k;
//
// then the absorb of csrc/chunk.cuh. Every round runs: convergence is the
// host schedule's verdict at super-step boundaries (parallel/overlap.py),
// from u[r], the converged count over the shard's middle rows after round
// r; under push-sum's global termination (the Global instance) u[r] is the
// middle's unstable count and the host takes the exact stop round from it
// (parallel/fused_sharded.py global_verdict). Round j computes only its
// window W_j (csrc/shard.cuh's contract), the rows the middle still depends
// on, which the host passes in.
//
// What bounds it on this card: launches, grid barriers and the host's
// queueing of them (two shard calls a super-step), then the per-slot
// integer work (the hash), on buffers of up to the JAX plan's 100 MB.
//
// Design: one persistent cooperative launch a super-step (all blocks
// resident, cudaLaunchCooperativeKernel), one pass a round. A prologue
// writes round 0's marks over W_{-1}; round j's pass absorbs the slots of
// W_j and writes each slot's mark for round j + 1 beside its new state (in
// gossip from the active flag it has just computed, in a register). Marks
// are double-buffered by round parity, so one grid barrier a round orders
// everything: pass j reads mark[j & 1] and writes mark[(j + 1) & 1], which
// pass j - 1 last read before the barrier between the two passes; pass j
// writes the plane set that pass j - 1 read, behind the same barrier. The
// input planes are never written: round j writes `out` when (rounds - 1 -
// j) is even, else `y`, and reads the planes the round before wrote (round
// 0 reads `in`), so the last round lands in `out` and a super-step whose
// result is discarded (the deferred verdict's rollback) leaves its input
// intact. Each block adds its middle count into u[j]; block 0 zeroes
// u[0..rounds) before the first barrier, writes -1 for the rounds not run
// and u[cr] = rounds run. The barrier's two counter words are reset by the
// last block to leave, so the next launch finds them zero. A launch whose
// done flag (ctrl[0]) is set runs no round.
//
// The verdict (gossip_stencil_shard_verdict, the kernel of csrc/chunk.cuh)
// is a one-thread launch that sums the shards' u at the super-step's last
// round against the target, counts the super-step's rounds in ctrl[1] and
// sets ctrl[0]; both sharded lattice compositions use it.
//
// Numerics: built without fast math, with -fmad=false and denormals kept;
// the halve happens before the class sums, which run from 0.0 in ascending
// class order, as in every other lattice kernel of the port.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "shard.cuh"
#include "stencil.cuh"

namespace {

using gossip::GossipPlanes;
using gossip::PushSumPlanes;
using gossip::ShardClasses;
using gossip::ShardGeom;
using gossip::ShardWindows;
using gossip::block_sum;
using gossip::kBlock;
using gossip::word_mark;

// Waits until `target` arrivals have reached *arrived, counting this
// block's; every thread's earlier writes are visible grid-wide after it.
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

// Block 0's bookkeeping at entry: u[r] = 0 for the rounds this launch runs,
// -1 for the others, u[cr] = that count. Returns the count.
__device__ __forceinline__ int start_superstep(int rounds, int cr, int* u,
                                               const int* ctrl) {
  const int ex = ctrl[0] ? 0 : rounds;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int r = 0; r < cr; ++r) u[r] = r < ex ? 0 : -1;
    u[cr] = ex;
  }
  return ex;
}

// The last block to leave resets the barrier words (bar[0] arrivals,
// bar[1] departures): every block has passed its last barrier by then.
__device__ __forceinline__ void release_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
    bar[0] = 0u;
    bar[1] = 0u;
    __threadfence();
  }
}

// Round 0's marks over W_{-1}; `active` is the input's active plane
// (gossip) or null (push-sum: every node of degree > 0 sends).
__device__ __forceinline__ void prologue_marks(int8_t* mark, const int* active,
                                               const int* __restrict__ dirs,
                                               const long long* keys,
                                               const ShardGeom& G,
                                               const ShardWindows& W) {
  const uint32_t k0 = (uint32_t)keys[0], k1 = (uint32_t)keys[1];
  for (int x = W.lo[0] * 128 + blockIdx.x * kBlock + threadIdx.x;
       x < W.hi[0] * 128; x += gridDim.x * kBlock) {
    const int g = gossip::shard_global_flat(G, x);
    mark[x] = active == nullptr || active[x] != 0 ? word_mark(dirs[g], k0, k1, g)
                                                  : (int8_t)-1;
  }
}

// Global: global termination. Term and conv stream through unchanged, and
// u[j] counts the middle's real nodes whose ratio moved more than the
// global rule allows in round j (csrc/faults.cuh absorb_global); the host
// sums the shards' u, and the first round where the sum is 0 ends the run
// (a rerun capped there, then conv latched on every real node). Global =
// false is the local-termination kernel, with none of this.
template <bool Global>
__global__ void pushsum_shard_rounds(PushSumPlanes in, PushSumPlanes out,
                                     PushSumPlanes y, int8_t* mark,
                                     const long long* keys,
                                     const int* __restrict__ dirs, int n,
                                     ShardClasses sc, ShardGeom G,
                                     ShardWindows W, int rounds, int cr,
                                     float delta, int term_rounds, int* u,
                                     const int* ctrl, unsigned* bar) {
  const int ex = start_superstep(rounds, cr, u, ctrl);
  if (ex == 0) return;
  const int n_ext = G.rows_ext * 128;
  prologue_marks(mark, nullptr, dirs, keys, G, W);
  unsigned barriers = 0;
  grid_barrier(bar, ++barriers * gridDim.x);
  for (int j = 0; j < ex; ++j) {
    const bool to_out = ((ex - 1 - j) & 1) == 0;
    const PushSumPlanes dst = to_out ? out : y;
    const PushSumPlanes src = j == 0 ? in : (to_out ? y : out);
    const int8_t* mk = mark + (j & 1) * n_ext;
    int8_t* next = j + 1 < ex ? mark + ((j + 1) & 1) * n_ext : nullptr;
    const uint32_t k0 = next ? (uint32_t)keys[2 * j + 2] : 0u;
    const uint32_t k1 = next ? (uint32_t)keys[2 * j + 3] : 0u;
    int c = 0;
    for (int x = W.lo[j + 1] * 128 + blockIdx.x * kBlock + threadIdx.x;
         x < W.hi[j + 1] * 128; x += gridDim.x * kBlock) {
      const int g = gossip::shard_global_flat(G, x);
      const bool pad = g >= n;
      float in_s = 0.0f, in_w = 0.0f;
      if (!pad)
        gossip::shard_pushsum_inbox(sc, mk, src.s, src.w, x, g, n_ext, in_s,
                                    in_w);
      // mk[x] < 0 on pad lanes and degree 0: those keep their mass.
      int cv;
      if constexpr (Global)
        cv = gossip::pushsum_absorb_global_node(src, dst, x, pad, mk[x] >= 0,
                                                in_s, in_w, delta);
      else
        cv = gossip::pushsum_absorb_node(src, dst, x, pad, mk[x] >= 0, in_s,
                                         in_w, delta, term_rounds);
      if (next) next[x] = word_mark(dirs[g], k0, k1, g);
      c += gossip::shard_middle(G, x) ? cv : 0;
    }
    const int block_count = block_sum(c);
    if (threadIdx.x == 0) atomicAdd(u + j, block_count);
    if (next) grid_barrier(bar, ++barriers * gridDim.x);
  }
  release_barrier(bar);
}

__global__ void gossip_shard_rounds(GossipPlanes in, GossipPlanes out,
                                    GossipPlanes y, int8_t* mark,
                                    const long long* keys,
                                    const int* __restrict__ dirs, int n,
                                    ShardClasses sc, ShardGeom G,
                                    ShardWindows W, int rounds, int cr,
                                    int rumor_target, int suppress, int* u,
                                    const int* ctrl, unsigned* bar) {
  const int ex = start_superstep(rounds, cr, u, ctrl);
  if (ex == 0) return;
  const int n_ext = G.rows_ext * 128;
  prologue_marks(mark, in.active, dirs, keys, G, W);
  unsigned barriers = 0;
  grid_barrier(bar, ++barriers * gridDim.x);
  for (int j = 0; j < ex; ++j) {
    const bool to_out = ((ex - 1 - j) & 1) == 0;
    const GossipPlanes dst = to_out ? out : y;
    const GossipPlanes src = j == 0 ? in : (to_out ? y : out);
    const int8_t* mk = mark + (j & 1) * n_ext;
    int8_t* next = j + 1 < ex ? mark + ((j + 1) & 1) * n_ext : nullptr;
    const uint32_t k0 = next ? (uint32_t)keys[2 * j + 2] : 0u;
    const uint32_t k1 = next ? (uint32_t)keys[2 * j + 3] : 0u;
    int c = 0;
    for (int x = W.lo[j + 1] * 128 + blockIdx.x * kBlock + threadIdx.x;
         x < W.hi[j + 1] * 128; x += gridDim.x * kBlock) {
      const int g = gossip::shard_global_flat(G, x);
      const bool pad = g >= n;
      const int inbox = pad ? 0 : gossip::shard_gossip_inbox(sc, mk, x, g, n_ext);
      int cnt, act;
      const int cv = gossip::gossip_absorb(
          [&] { return src.conv[x] != 0; }, [&] { return src.count[x]; },
          [&] { return src.active[x]; }, pad, inbox, rumor_target, suppress,
          cnt, act);
      dst.count[x] = cnt;
      dst.active[x] = act;
      dst.conv[x] = cv;
      if (next) next[x] = act ? word_mark(dirs[g], k0, k1, g) : (int8_t)-1;
      c += gossip::shard_middle(G, x) ? cv : 0;
    }
    const int block_count = block_sum(c);
    if (threadIdx.x == 0) atomicAdd(u + j, block_count);
    if (next) grid_barrier(bar, ++barriers * gridDim.x);
  }
  release_barrier(bar);
}

// Blocks of the persistent launch over n_ext slots: as many as the SMs hold
// at once, at most one per 256 slots; an error if the card has no
// cooperative launch or the barrier count (rounds * grid) would overflow.
template <typename Kernel>
cudaError_t cooperative_grid(Kernel kernel, int n_ext, int rounds, int device,
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
  const long long want = ((long long)n_ext + kBlock - 1) / kBlock;
  const long long cap = (long long)sms * per_sm;
  *grid = (int)(want < cap ? want : cap);
  if ((long long)rounds * *grid >= (1LL << 32)) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Each super-step entry point queues one cooperative launch on `stream` of
// CUDA device `device` and returns its error (a cudaError_t), 0 if none.
// The plane sets (in, out, y) are [rows_ext, 128] each, in is read only;
// mark is int8[2 * rows_ext * 128]; keys int64[2 * rounds] on the device
// (round j's fold_in key at 2j, 2j + 1); dirs int32[R * 128] on the device,
// the static directions word of every global slot; classes, e1 and e2 are
// host arrays of the n_classes sorted displacement classes and their
// rolls; win a host array of the rounds + 1 windows (lo, hi) in extended
// rows, W_{-1} first; global (push-sum) picks the global-termination
// instance; u is int32[cr + 1]; ctrl int32[2] (done, rounds), read only
// here; bar is two zeroed uint32 words that the launch leaves
// zeroed.

extern "C" int gossip_pushsum_stencil_shard_superstep(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* s_y, float* w_y, int* term_y,
    int* conv_y, int8_t* mark, const long long* keys, const int* dirs,
    const int* classes, const int* e1, const int* e2, const int* win,
    int n_classes, int n, int R, int row0, int rows_ext, int H, int rows_loc,
    int rounds, int cr, float delta, int term_rounds, int global, int* u,
    const int* ctrl, unsigned* bar, int device, void* stream_ptr) {
  ShardClasses sc;
  ShardGeom G;
  ShardWindows W;
  if (rounds > cr ||
      !gossip::setup_shard(n, classes, n_classes, R, row0, rows_ext, H,
                           rows_loc, e1, e2, win, rounds, &G, &sc, &W))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  const void* kernel = global ? (const void*)pushsum_shard_rounds<true>
                              : (const void*)pushsum_shard_rounds<false>;
  err = global ? cooperative_grid(pushsum_shard_rounds<true>, rows_ext * 128,
                                  rounds, device, &grid)
               : cooperative_grid(pushsum_shard_rounds<false>, rows_ext * 128,
                                  rounds, device, &grid);
  if (err != cudaSuccess) return (int)err;
  PushSumPlanes in{(float*)s0, (float*)w0, (int*)t0, (int*)c0};
  PushSumPlanes out{s, w, term, conv};
  PushSumPlanes y{s_y, w_y, term_y, conv_y};
  void* args[] = {&in, &out,    &y,  &mark,  &keys,  &dirs,        &n,
                  &sc, &G,      &W,  &rounds, &cr,   &delta,       &term_rounds,
                  &u,  &ctrl,   &bar};
  return (int)cudaLaunchCooperativeKernel(kernel, grid, kBlock, args, 0,
                                          (cudaStream_t)stream_ptr);
}

extern "C" int gossip_gossip_stencil_shard_superstep(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int* count_y, int* active_y, int* conv_y, int8_t* mark,
    const long long* keys, const int* dirs, const int* classes, const int* e1,
    const int* e2, const int* win, int n_classes, int n, int R, int row0,
    int rows_ext, int H, int rows_loc, int rounds, int cr, int rumor_target,
    int suppress, int* u, const int* ctrl, unsigned* bar, int device,
    void* stream_ptr) {
  ShardClasses sc;
  ShardGeom G;
  ShardWindows W;
  if (rounds > cr ||
      !gossip::setup_shard(n, classes, n_classes, R, row0, rows_ext, H,
                           rows_loc, e1, e2, win, rounds, &G, &sc, &W))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int grid = 0;
  err = cooperative_grid(gossip_shard_rounds, rows_ext * 128, rounds, device,
                         &grid);
  if (err != cudaSuccess) return (int)err;
  GossipPlanes in{(int*)n0, (int*)a0, (int*)c0};
  GossipPlanes out{count, active, conv};
  GossipPlanes y{count_y, active_y, conv_y};
  void* args[] = {&in, &out, &y,      &mark, &keys,         &dirs,
                  &n,  &sc,  &G,      &W,    &rounds,       &cr,
                  &rumor_target,      &suppress, &u,        &ctrl,
                  &bar};
  return (int)cudaLaunchCooperativeKernel((const void*)gossip_shard_rounds,
                                          grid, kBlock, args, 0,
                                          (cudaStream_t)stream_ptr);
}

// The super-step verdict on the shards' u, int32 [shards, stride] with u at
// column `index`: one thread, on `stream` of `device`.
extern "C" int gossip_stencil_shard_verdict(const int* u, int stride,
                                            int shards, int index,
                                            int executed, int target,
                                            int* ctrl, int device,
                                            void* stream_ptr) {
  if (shards < 1 || index < 0 || index >= stride || executed < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  gossip::shard_verdict<<<1, 1, 0, (cudaStream_t)stream_ptr>>>(
      u, stride, shards, index, executed, target, ctrl);
  return (int)cudaGetLastError();
}
