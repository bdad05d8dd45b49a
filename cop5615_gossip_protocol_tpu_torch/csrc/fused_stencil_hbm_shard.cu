// Streaming sharded lattice super-steps, push-sum and gossip, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package's HBM-streaming fused
// x sharded composition: parallel/fused_hbm_sharded.py
// make_pushsum_stencil_hbm_shard_chunk (pallas_call at :773) and
// make_gossip_stencil_hbm_shard_chunk (:1069). They compute the function of
// csrc/fused_stencil_shard.cu on shards past that composition's 100 MB
// plane budget (torus3d 256**3 in 2 or 4 shards: ~100-200 MB of planes a
// shard, several times the 50 MB L2), with the classes' rolls from the
// streaming plan (_class_sigmas: one roll per class on the non-wrap
// lattices and on wrap lattices without pad lanes), over the same windows
// (csrc/shard.cuh's contract: round j computes only the rows W_j the
// middle still depends on).
//
// What bounds it on this card: HBM bytes. A round reads and writes the
// shard's window once, plus the class gathers, which hit the L2 for the
// near classes; then the hash, one per sending slot a round.
//
// Design: one launch a round, queued by one C call for the whole
// super-step, after a prologue:
//   prologue - each sender of W_{-1} draws at its global flat index and
//              writes its round-0 class index (int8, -1 for none); block 0
//              zeroes u for the rounds run and writes -1 for the others,
//              u[cr] = rounds run;
//   round j  - each receiver of W_j gathers its class sources from the
//              round's planes and marks, writes the absorbed state to the
//              other set and, unless j is the last round, its own mark for
//              round j + 1 (in gossip from the active flag it has just
//              computed); each block adds its middle-row count into u[j].
// Marks are double-buffered by round parity: round j reads mark[j & 1] and
// writes mark[(j + 1) & 1], which round j - 1 last read, and the launch
// boundary between the two orders them. The plane sets are used as in
// csrc/fused_stencil_shard.cu: `in` is read only, the last round writes
// `out`, the others alternate with `y`. Every launch returns at once when
// the done flag (ctrl[0]) is set. Row 17 (gossip) shares the prologue, the
// geometry and the launch loop.
//
// Numerics: built without fast math, with -fmad=false and denormals kept.
// The JAX kernels halve after the class sums; this one halves each source
// before them, as every lattice kernel of the port does, which is the same
// float32 result unless an operand is subnormal.

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
using gossip::grid_for;
using gossip::kBlock;
using gossip::word_mark;

// Round 0's marks over rows [lo, hi) = W_{-1}. `active` is the input's
// active plane (gossip) or null (push-sum: every node of degree > 0 sends).
__global__ void shard_prologue(int8_t* mark, const int* active,
                               const int* __restrict__ dirs,
                               const long long* key, ShardGeom G, int lo,
                               int hi, int rounds, int cr, int* u,
                               const int* ctrl) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int ex = ctrl[0] ? 0 : rounds;
    for (int r = 0; r < cr; ++r) u[r] = r < ex ? 0 : -1;
    u[cr] = ex;
  }
  if (ctrl[0]) return;
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  for (int x = lo * 128 + blockIdx.x * kBlock + threadIdx.x; x < hi * 128;
       x += gridDim.x * kBlock) {
    const int g = gossip::shard_global_flat(G, x);
    mark[x] = active == nullptr || active[x] != 0 ? word_mark(dirs[g], k0, k1, g)
                                                  : (int8_t)-1;
  }
}

// Round j over rows [lo, hi) = W_j: reads `mark`, writes `next` (round
// j + 1's marks under `key`) unless it is null. Global: global termination,
// as in csrc/fused_stencil_shard.cu: term and conv stream through and u_j
// counts the middle's real nodes whose ratio moved more than the global
// rule allows.
template <bool Global>
__global__ void pushsum_shard_round(PushSumPlanes src, PushSumPlanes dst,
                                    const int8_t* __restrict__ mark,
                                    int8_t* __restrict__ next,
                                    const long long* key,
                                    const int* __restrict__ dirs, int n,
                                    ShardClasses sc, ShardGeom G, int lo,
                                    int hi, float delta, int term_rounds,
                                    int* u_j, const int* ctrl) {
  if (ctrl[0]) return;
  const int n_ext = G.rows_ext * 128;
  const uint32_t k0 = next ? (uint32_t)key[0] : 0u;
  const uint32_t k1 = next ? (uint32_t)key[1] : 0u;
  int c = 0;
  for (int x = lo * 128 + blockIdx.x * kBlock + threadIdx.x; x < hi * 128;
       x += gridDim.x * kBlock) {
    const int g = gossip::shard_global_flat(G, x);
    const bool pad = g >= n;
    float in_s = 0.0f, in_w = 0.0f;
    if (!pad)
      gossip::shard_pushsum_inbox(sc, mark, src.s, src.w, x, g, n_ext, in_s,
                                  in_w);
    // mark[x] < 0 on pad lanes and degree 0: those keep their mass.
    int cv;
    if constexpr (Global)
      cv = gossip::pushsum_absorb_global_node(src, dst, x, pad, mark[x] >= 0,
                                              in_s, in_w, delta);
    else
      cv = gossip::pushsum_absorb_node(src, dst, x, pad, mark[x] >= 0, in_s,
                                       in_w, delta, term_rounds);
    if (next) next[x] = word_mark(dirs[g], k0, k1, g);
    c += gossip::shard_middle(G, x) ? cv : 0;
  }
  const int block_count = block_sum(c);
  if (threadIdx.x == 0) atomicAdd(u_j, block_count);
}

__global__ void gossip_shard_round(GossipPlanes src, GossipPlanes dst,
                                   const int8_t* __restrict__ mark,
                                   int8_t* __restrict__ next,
                                   const long long* key,
                                   const int* __restrict__ dirs, int n,
                                   ShardClasses sc, ShardGeom G, int lo,
                                   int hi, int rumor_target, int suppress,
                                   int* u_j, const int* ctrl) {
  if (ctrl[0]) return;
  const int n_ext = G.rows_ext * 128;
  const uint32_t k0 = next ? (uint32_t)key[0] : 0u;
  const uint32_t k1 = next ? (uint32_t)key[1] : 0u;
  int c = 0;
  for (int x = lo * 128 + blockIdx.x * kBlock + threadIdx.x; x < hi * 128;
       x += gridDim.x * kBlock) {
    const int g = gossip::shard_global_flat(G, x);
    const bool pad = g >= n;
    const int inbox = pad ? 0 : gossip::shard_gossip_inbox(sc, mark, x, g, n_ext);
    int cnt, act;
    const int cv = gossip::gossip_absorb(
        [&] { return src.conv[x] != 0; }, [&] { return src.count[x]; },
        [&] { return src.active[x]; }, pad, inbox, rumor_target, suppress, cnt,
        act);
    dst.count[x] = cnt;
    dst.active[x] = act;
    dst.conv[x] = cv;
    if (next) next[x] = act ? word_mark(dirs[g], k0, k1, g) : (int8_t)-1;
    c += gossip::shard_middle(G, x) ? cv : 0;
  }
  const int block_count = block_sum(c);
  if (threadIdx.x == 0) atomicAdd(u_j, block_count);
}

// Round j's (src, dst) plane sets: the last round writes `out`.
template <typename Planes>
void round_sets(const Planes& in, const Planes& out, const Planes& y, int j,
                int rounds, Planes* src, Planes* dst) {
  const bool to_out = ((rounds - 1 - j) & 1) == 0;
  *dst = to_out ? out : y;
  *src = j == 0 ? in : (to_out ? y : out);
}

// Round j's mark buffers: it reads mark[j & 1] and writes round j + 1's
// into mark[(j + 1) & 1], none after the last round.
void round_marks(int8_t* mark, int n_ext, int j, int rounds, int8_t** cur,
                 int8_t** next) {
  *cur = mark + (j & 1) * n_ext;
  *next = j + 1 < rounds ? mark + ((j + 1) & 1) * n_ext : nullptr;
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// The arguments of csrc/fused_stencil_shard.cu's entry points (push-sum's
// global flag included), without the barrier words; mark is int8[2 * rows_ext * 128]. Each queues rounds + 1
// launches (the prologue, then one a round) on `stream` of CUDA device
// `device` and returns the first error (a cudaError_t), 0 if none.

extern "C" int gossip_pushsum_stencil_hbm_shard_superstep(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* s_y, float* w_y, int* term_y,
    int* conv_y, int8_t* mark, const long long* keys, const int* dirs,
    const int* classes, const int* e1, const int* e2, const int* win,
    int n_classes, int n, int R, int row0, int rows_ext, int H, int rows_loc,
    int rounds, int cr, float delta, int term_rounds, int global, int* u,
    const int* ctrl, int device, void* stream_ptr) {
  ShardClasses sc;
  ShardGeom G;
  ShardWindows W;
  if (rounds > cr ||
      !gossip::setup_shard(n, classes, n_classes, R, row0, rows_ext, H,
                           rows_loc, e1, e2, win, rounds, &G, &sc, &W))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_ext = rows_ext * 128;
  const int mark_grid = grid_for(shard_prologue, n_ext, device);
  const int round_grid = global ? grid_for(pushsum_shard_round<true>, n_ext, device)
                                : grid_for(pushsum_shard_round<false>, n_ext, device);
  const PushSumPlanes in{(float*)s0, (float*)w0, (int*)t0, (int*)c0};
  const PushSumPlanes out{s, w, term, conv};
  const PushSumPlanes y{s_y, w_y, term_y, conv_y};
  shard_prologue<<<mark_grid, kBlock, 0, stream>>>(
      mark, nullptr, dirs, keys, G, W.lo[0], W.hi[0], rounds, cr, u, ctrl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int j = 0; j < rounds; ++j) {
    PushSumPlanes src, dst;
    int8_t *cur, *next;
    round_sets(in, out, y, j, rounds, &src, &dst);
    round_marks(mark, n_ext, j, rounds, &cur, &next);
    if (global)
      pushsum_shard_round<true><<<round_grid, kBlock, 0, stream>>>(
          src, dst, cur, next, keys + 2 * (j + 1), dirs, n, sc, G, W.lo[j + 1],
          W.hi[j + 1], delta, term_rounds, u + j, ctrl);
    else
      pushsum_shard_round<false><<<round_grid, kBlock, 0, stream>>>(
          src, dst, cur, next, keys + 2 * (j + 1), dirs, n, sc, G, W.lo[j + 1],
          W.hi[j + 1], delta, term_rounds, u + j, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int gossip_gossip_stencil_hbm_shard_superstep(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int* count_y, int* active_y, int* conv_y, int8_t* mark,
    const long long* keys, const int* dirs, const int* classes, const int* e1,
    const int* e2, const int* win, int n_classes, int n, int R, int row0,
    int rows_ext, int H, int rows_loc, int rounds, int cr, int rumor_target,
    int suppress, int* u, const int* ctrl, int device, void* stream_ptr) {
  ShardClasses sc;
  ShardGeom G;
  ShardWindows W;
  if (rounds > cr ||
      !gossip::setup_shard(n, classes, n_classes, R, row0, rows_ext, H,
                           rows_loc, e1, e2, win, rounds, &G, &sc, &W))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_ext = rows_ext * 128;
  const int mark_grid = grid_for(shard_prologue, n_ext, device);
  const int round_grid = grid_for(gossip_shard_round, n_ext, device);
  const GossipPlanes in{(int*)n0, (int*)a0, (int*)c0};
  const GossipPlanes out{count, active, conv};
  const GossipPlanes y{count_y, active_y, conv_y};
  shard_prologue<<<mark_grid, kBlock, 0, stream>>>(
      mark, a0, dirs, keys, G, W.lo[0], W.hi[0], rounds, cr, u, ctrl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int j = 0; j < rounds; ++j) {
    GossipPlanes src, dst;
    int8_t *cur, *next;
    round_sets(in, out, y, j, rounds, &src, &dst);
    round_marks(mark, n_ext, j, rounds, &cur, &next);
    gossip_shard_round<<<round_grid, kBlock, 0, stream>>>(
        src, dst, cur, next, keys + 2 * (j + 1), dirs, n, sc, G, W.lo[j + 1],
        W.hi[j + 1], rumor_target, suppress, u + j, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
