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
// lattices and on wrap lattices without pad lanes).
//
// What bounds it on this card: HBM bytes. A round reads and writes the
// shard's extended state once, plus the class gathers, which hit the L2
// for the near classes.
//
// Design: csrc/fused_stencil.cu's two launches a round over the shard's
// plane sets, queued by one C call for the whole super-step:
//   mark   - each sender draws at its global flat index and writes its
//            class index (int8, -1 for none);
//   absorb - each receiver gathers its class sources from the round's
//            planes and writes the absorbed state to the other set; each
//            block adds its middle-row count into u[j].
// The plane sets are used as in csrc/fused_stencil_shard.cu: `in` is read
// only, the last round writes `out`, the others alternate with `y`. The
// first mark launch's block 0 zeroes u for the rounds run and writes -1 for
// the others, u[cr] = rounds run; every launch returns at once when the
// done flag (ctrl[0]) is set.
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
using gossip::block_sum;
using gossip::grid_for;
using gossip::kBlock;
using gossip::mark_of;

// The mark launch of round j. `active` is the round's active plane (gossip)
// or null (push-sum: every node of degree > 0 sends).
__global__ void shard_mark(int8_t* mark, const int* active,
                           const long long* key, gossip::Lattice L,
                           ShardClasses sc, ShardGeom G, int j, int rounds,
                           int cr, int* u, const int* ctrl) {
  if (j == 0 && blockIdx.x == 0 && threadIdx.x == 0) {
    const int ex = ctrl[0] ? 0 : rounds;
    for (int r = 0; r < cr; ++r) u[r] = r < ex ? 0 : -1;
    u[cr] = ex;
  }
  if (ctrl[0]) return;
  const int n = L.n, n_ext = G.rows_ext * 128;
  for (int x = blockIdx.x * kBlock + threadIdx.x; x < n_ext;
       x += gridDim.x * kBlock) {
    const int g = gossip::shard_global_flat(G, x);
    const bool sending = g < n && (active == nullptr || active[x] != 0);
    mark[x] = sending ? mark_of(L, sc.cls, key, g) : (int8_t)-1;
  }
}

__global__ void pushsum_shard_absorb(PushSumPlanes src, PushSumPlanes dst,
                                     const int8_t* __restrict__ mark, int n,
                                     ShardClasses sc, ShardGeom G, float delta,
                                     int term_rounds, int* u_j,
                                     const int* ctrl) {
  if (ctrl[0]) return;
  const int n_ext = G.rows_ext * 128;
  int c = 0;
  for (int x = blockIdx.x * kBlock + threadIdx.x; x < n_ext;
       x += gridDim.x * kBlock) {
    const int g = gossip::shard_global_flat(G, x);
    const bool pad = g >= n;
    float in_s = 0.0f, in_w = 0.0f;
    if (!pad)
      gossip::shard_pushsum_inbox(sc, mark, src.s, src.w, x, g, n_ext, in_s,
                                  in_w);
    // mark[x] < 0 on pad lanes and degree 0: those keep their mass.
    const int cv = gossip::pushsum_absorb_node(src, dst, x, pad, mark[x] >= 0,
                                               in_s, in_w, delta, term_rounds);
    c += gossip::shard_middle(G, x) ? cv : 0;
  }
  const int block_count = block_sum(c);
  if (threadIdx.x == 0) atomicAdd(u_j, block_count);
}

__global__ void gossip_shard_absorb(GossipPlanes src, GossipPlanes dst,
                                    const int8_t* __restrict__ mark, int n,
                                    ShardClasses sc, ShardGeom G,
                                    int rumor_target, int suppress, int* u_j,
                                    const int* ctrl) {
  if (ctrl[0]) return;
  const int n_ext = G.rows_ext * 128;
  int c = 0;
  for (int x = blockIdx.x * kBlock + threadIdx.x; x < n_ext;
       x += gridDim.x * kBlock) {
    const int g = gossip::shard_global_flat(G, x);
    const bool pad = g >= n;
    const int inbox = pad ? 0 : gossip::shard_gossip_inbox(sc, mark, x, g, n_ext);
    const int cv = gossip::gossip_absorb_node(src, dst, x, pad, inbox,
                                              rumor_target, suppress);
    c += gossip::shard_middle(G, x) ? cv : 0;
  }
  const int block_count = block_sum(c);
  if (threadIdx.x == 0) atomicAdd(u_j, block_count);
}

bool setup(int kind, int n, int extra_node, const int* classes, const int* e1,
           const int* e2, int n_classes, int R, int row0, int rows_ext, int H,
           int rows_loc, int rounds, int cr, gossip::Lattice* L,
           ShardClasses* sc, ShardGeom* G) {
  gossip::Classes cls;
  return rounds >= 1 && rounds <= cr &&
         gossip::setup_lattice(kind, n, extra_node, classes, n_classes, L,
                               &cls) &&
         gossip::setup_shard(R, row0, rows_ext, H, rows_loc, e1, e2, cls, G,
                             sc);
}

// Round j's (src, dst) plane sets: the last round writes `out`.
template <typename Planes>
void round_sets(const Planes& in, const Planes& out, const Planes& y, int j,
                int rounds, Planes* src, Planes* dst) {
  const bool to_out = ((rounds - 1 - j) & 1) == 0;
  *dst = to_out ? out : y;
  *src = j == 0 ? in : (to_out ? y : out);
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// The arguments of csrc/fused_stencil_shard.cu's entry points, without the
// barrier words; mark is int8[rows_ext * 128]. Each queues 2 * rounds
// launches (mark, absorb per round) on `stream` of CUDA device `device` and
// returns the first error (a cudaError_t), 0 if none.

extern "C" int gossip_pushsum_stencil_hbm_shard_superstep(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* s_y, float* w_y, int* term_y,
    int* conv_y, int8_t* mark, const long long* keys, const int* classes,
    const int* e1, const int* e2, int n_classes, int kind, int n,
    int extra_node, int R, int row0, int rows_ext, int H, int rows_loc,
    int rounds, int cr, float delta, int term_rounds, int* u, const int* ctrl,
    int device, void* stream_ptr) {
  gossip::Lattice L;
  ShardClasses sc;
  ShardGeom G;
  if (!setup(kind, n, extra_node, classes, e1, e2, n_classes, R, row0,
             rows_ext, H, rows_loc, rounds, cr, &L, &sc, &G))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long n_ext = (long long)rows_ext * 128;
  const int mark_grid = grid_for(shard_mark, n_ext, device);
  const int absorb_grid = grid_for(pushsum_shard_absorb, n_ext, device);
  const PushSumPlanes in{(float*)s0, (float*)w0, (int*)t0, (int*)c0};
  const PushSumPlanes out{s, w, term, conv};
  const PushSumPlanes y{s_y, w_y, term_y, conv_y};
  for (int j = 0; j < rounds; ++j) {
    PushSumPlanes src, dst;
    round_sets(in, out, y, j, rounds, &src, &dst);
    shard_mark<<<mark_grid, kBlock, 0, stream>>>(mark, nullptr, keys + 2 * j,
                                                 L, sc, G, j, rounds, cr, u,
                                                 ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pushsum_shard_absorb<<<absorb_grid, kBlock, 0, stream>>>(
        src, dst, mark, n, sc, G, delta, term_rounds, u + j, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int gossip_gossip_stencil_hbm_shard_superstep(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int* count_y, int* active_y, int* conv_y, int8_t* mark,
    const long long* keys, const int* classes, const int* e1, const int* e2,
    int n_classes, int kind, int n, int extra_node, int R, int row0,
    int rows_ext, int H, int rows_loc, int rounds, int cr, int rumor_target,
    int suppress, int* u, const int* ctrl, int device, void* stream_ptr) {
  gossip::Lattice L;
  ShardClasses sc;
  ShardGeom G;
  if (!setup(kind, n, extra_node, classes, e1, e2, n_classes, R, row0,
             rows_ext, H, rows_loc, rounds, cr, &L, &sc, &G))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long n_ext = (long long)rows_ext * 128;
  const int mark_grid = grid_for(shard_mark, n_ext, device);
  const int absorb_grid = grid_for(gossip_shard_absorb, n_ext, device);
  const GossipPlanes in{(int*)n0, (int*)a0, (int*)c0};
  const GossipPlanes out{count, active, conv};
  const GossipPlanes y{count_y, active_y, conv_y};
  for (int j = 0; j < rounds; ++j) {
    GossipPlanes src, dst;
    round_sets(in, out, y, j, rounds, &src, &dst);
    shard_mark<<<mark_grid, kBlock, 0, stream>>>(mark, src.active,
                                                 keys + 2 * j, L, sc, G, j,
                                                 rounds, cr, u, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gossip_shard_absorb<<<absorb_grid, kBlock, 0, stream>>>(
        src, dst, mark, n, sc, G, rumor_target, suppress, u + j, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
