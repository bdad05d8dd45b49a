// One round of the imp x HBM x sharded composition over one shard, the
// absorb of push-sum and gossip with the next round's marks, and the mark
// prologue, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's
// parallel/fused_imp_hbm_sharded.py: make_pushsum_imp_hbm_shard_chunk
// (pallas_call at :678) and make_gossip_imp_hbm_shard_chunk (:939). A shard
// owns global rows [row_lo, row_lo + rows_loc) of the pool layout's
// [R, 128] planes; a round advances them by one round of the single-device
// imp trajectory (csrc/fused_imp.cu):
//
//   class(i) = the lattice class word(i) picks with threefry(k1, k2, i),
//              or for its long-range slot L + its pool slot in the packed
//              word threefry(c1, c2, choice_counter(i))
//                                             (csrc/imp.cuh, imp_mark)
//   inbox[j] = sum from 0.0 over the L lattice classes q in sorted order,
//              then the P pool slots p, of send[i] * [class(i) == id],
//              i = j - d mod n, (id, d) = (q, d_q) or (L + p, offs[p])
//
// then the absorb with the term/conv latch (push-sum) or the receipt count
// with receiver-side suppression (gossip).
//
// The TPU kernel streams a halo-extended shard through VMEM tiles and
// regenerates, inside every tile, the marks of each lattice window and each
// pool window it fetches, because a tile load needs a static window. Here
// each device keeps two global int8 mark planes, by round parity, and a
// round is one launch a shard:
//   absorb - after the wire has copied every shard's round-r marks (and
//            push-sum's s and w) into the device's global copies
//            (parallel/halo.py), one thread per receiver of the shard's
//            rows gathers, per class, the send of its class source whose
//            mark in mark[r % 2] is that class, writes the shard's next
//            planes (ping/pong sets chosen by the host) and its own round
//            r + 1 mark into mark[(r + 1) % 2] (gossip from the active flag
//            it has just computed; the choice word hashed only for the
//            long-range slot, as in csrc/fused_imp.cu);
//   prologue - a mark launch a shard writes round r's marks into mark[r %
//            2], only where a run starts or resumes.
// So no halo exists and each node's mark is computed once a round. Round
// r + 1 reads mark[(r + 1) % 2] and the plane set round r wrote, and
// writes only mark[r % 2] and round r's input set, so a deferred verdict
// that stops the run after round r finds round r's output whole. The launch
// writes u, the shard's converged count, to a device slot; the verdict
// (csrc/fused_pool2_shard.cu, gossip_pool2_shard_verdict) sums the slots
// into the run's done flag and round counter, and every launch returns at
// once once that flag is set.
//
// Global termination (the JAX composition's global_term,
// parallel/fused_imp_hbm_sharded.py:400, :580, its verdict by shifted
// metric :1134-1142 and latch :1179-1189): a template flag G picks the
// push-sum absorb's global instance, so the fault-free one keeps its code.
// Under G term and conv stay and u is the shard's count of real nodes whose
// ratio moved more than delta * max(|s/w|, 1) (csrc/faults.cuh
// unstable_global); the verdict fires when the shards' counts sum to zero,
// and the run latches conv on every real node of its result. The JAX plan
// refuses the drop gate and crash-stop here.//
// What bounds it on this card: memory traffic. A round over a shard reads
// and writes its state once (push-sum 16 bytes a node each way, gossip 12),
// reads its directions words (4 bytes a node) and writes its next marks (1
// byte a node), and reads, per class, a source's mark and, for push-sum,
// its s and w: the lattice sources lie within +-g*g nodes and hit the L2,
// but each pool class reads a window a random distance away, P more
// streams of the mark plane (and of s and w). The arithmetic is a 20-round
// Threefry hash per node, a second one for a node that draws its
// long-range slot, the slot select and one compare per class a node.
//
// Numerics: see csrc/chunk.cuh; the halve happens before the class sums,
// which run from 0.0 in class order, as in csrc/fused_imp.cu, so push-sum
// is bitwise the plain version and the single-device run. Every flat index
// is an int below n_pad + n < 2**31 (the plan's 2**27-node shards, and up
// to 520**3 in all, stay far below it).

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "imp.cuh"

namespace {

using gossip::Classes;
using gossip::ImpPool;
using gossip::block_sum;
using gossip::finish_shard_count;
using gossip::kBlock;
using gossip::kChoiceLanes;
using gossip::round_grid;

// The marks a launch writes for the shard's rows: a global int8 plane, the
// global directions words and the round's key and choice key.
struct MarkOut {
  int8_t* mark;
  const uint32_t* words;
  uint32_t k1, k2, c1, c2;
  int pool_size;
};

// Node j's mark into `out`: -1 on a pad lane or when it does not send.
__device__ __forceinline__ void write_mark(const MarkOut& out, int j, bool sends,
                                           int lattice_count) {
  out.mark[j] = sends ? gossip::imp_mark(out.words[j], out.k1, out.k2, out.c1,
                                         out.c2, j, out.pool_size, lattice_count)
                      : (int8_t)-1;
}

// Round marks of the shard's rows [row_lo, row_lo + rows) into `out`.
// `active` is the shard's gossip active plane (local rows); push-sum passes
// nullptr and every real node sends.
__global__ void imp_shard_prologue(MarkOut out, const int* __restrict__ active,
                                   int lattice_count, int n, int row_lo,
                                   int count, const int* __restrict__ ctrl) {
  if (ctrl[0]) return;
  const int base = row_lo * kChoiceLanes;
  for (int l = blockIdx.x * kBlock + threadIdx.x; l < count;
       l += gridDim.x * kBlock)
    write_mark(out, base + l,
               base + l < n && (active == nullptr || active[l] != 0),
               lattice_count);
}

// The shard's operands of one absorb, passed by value.
struct ShardAbsorb {
  Classes lattice;
  ImpPool pool;
  int n, row_lo, count;  // count = rows_loc * 128 receivers
  int* u;                // the shard's converged count
  int* acc;              // [2]: block total, ticket; zero between launches
  const int* ctrl;       // [2]: done, rounds
};

// s_in/w_in and s_out/w_out are the device's global planes (flat index j),
// t_*/c_* the shard's own (local index l = j - row_lo * 128); reads `mark`,
// writes the next round's marks through `next`. G: global termination (see
// the header); G = false is the fault-free kernel.
template <bool G>
__global__ void pushsum_imp_shard_absorb(
    const float* __restrict__ s_in, const float* __restrict__ w_in,
    float* __restrict__ s_out, float* __restrict__ w_out,
    const int* __restrict__ t_in, const int* __restrict__ c_in,
    int* __restrict__ t_out, int* __restrict__ c_out,
    const int8_t* __restrict__ mark, MarkOut next, ShardAbsorb p, float delta,
    int term_rounds) {
  if (p.ctrl[0]) return;
  const int base = p.row_lo * kChoiceLanes;
  int c = 0;
  for (int l = blockIdx.x * kBlock + threadIdx.x; l < p.count;
       l += gridDim.x * kBlock) {
    const int j = base + l;
    const bool pad = j >= p.n;
    float in_s = 0.0f, in_w = 0.0f;
    if (!pad)
      gossip::imp_pushsum_inbox(p.lattice, p.pool, mark, s_in, w_in, j, p.n,
                                in_s, in_w);
    float s_new, w_new;
    if constexpr (!G) {
      // mark[j] < 0 on pad lanes: those keep their mass.
      int t_new;
      const int cv = gossip::pushsum_absorb(
          s_in[j], w_in[j], [&] { return t_in[l]; },
          [&] { return c_in[l] != 0; }, pad, mark[j] >= 0, in_s, in_w, delta,
          term_rounds, s_new, w_new, t_new);
      s_out[j] = s_new;
      w_out[j] = w_new;
      t_out[l] = t_new;
      c_out[l] = cv;
      c += cv;
    } else {
      // Global termination: term and conv stay; the count is the real
      // nodes whose ratio moved more than the global rule allows.
      const bool unstable = gossip::absorb_global(
          s_in[j], w_in[j], pad, mark[j] >= 0, in_s, in_w, delta, s_new, w_new);
      s_out[j] = s_new;
      w_out[j] = w_new;
      t_out[l] = t_in[l];
      c_out[l] = c_in[l];
      c += unstable ? 1 : 0;
    }
    write_mark(next, j, !pad, p.lattice.count);
  }
  finish_shard_count(block_sum(c), p.acc, p.u);
}

// The shard's own (count, active, conv) planes, local index.
__global__ void gossip_imp_shard_absorb(
    const int* __restrict__ n_in, const int* __restrict__ a_in,
    const int* __restrict__ c_in, int* __restrict__ n_out,
    int* __restrict__ a_out, int* __restrict__ c_out,
    const int8_t* __restrict__ mark, MarkOut next, ShardAbsorb p,
    int rumor_target, int suppress) {
  if (p.ctrl[0]) return;
  const int base = p.row_lo * kChoiceLanes;
  int c = 0;
  for (int l = blockIdx.x * kBlock + threadIdx.x; l < p.count;
       l += gridDim.x * kBlock) {
    const int j = base + l;
    const bool pad = j >= p.n;
    const int inbox =
        pad ? 0 : gossip::imp_gossip_inbox(p.lattice, p.pool, mark, j, p.n);
    int cnt, act;
    const int cv = gossip::gossip_absorb(
        [&] { return c_in[l] != 0; }, [&] { return n_in[l]; },
        [&] { return a_in[l]; }, pad, inbox, rumor_target, suppress, cnt, act);
    n_out[l] = cnt;
    a_out[l] = act;
    c_out[l] = cv;
    write_mark(next, j, !pad && act, p.lattice.count);
    c += cv;
  }
  finish_shard_count(block_sum(c), p.acc, p.u);
}

// The lattice classes from the C arguments; false if out of range.
bool lattice_classes(const int* classes, int n_classes, int n, Classes* lattice) {
  if (n_classes < 1 || n_classes > gossip::kMaxDirs) return false;
  lattice->count = n_classes;
  for (int k = 0; k < gossip::kMaxClasses; ++k) {
    lattice->d[k] = k < n_classes ? classes[k] : 0;
    if (k < n_classes && (lattice->d[k] < 1 || lattice->d[k] >= n)) return false;
  }
  return true;
}

bool valid_rows(int n, int row_lo, int rows) {
  return n >= 2 && row_lo >= 0 && rows >= 1 &&
         (long long)(row_lo + rows) * kChoiceLanes < (1LL << 31);
}

// The marks' operands from the C arguments; false if out of range.
bool make_marks(int8_t* mark, const uint32_t* words, unsigned k1, unsigned k2,
                unsigned c1, unsigned c2, int pool_size, MarkOut* out) {
  if (pool_size < 2 || pool_size > gossip::kMaxImpPool ||
      (pool_size & (pool_size - 1)) != 0)
    return false;
  *out = MarkOut{mark, words, k1, k2, c1, c2, pool_size};
  return true;
}

// The absorb operands from the C arguments; false if out of range.
bool make_absorb(const int* classes, int n_classes, const int* offs,
                 int pool_size, int n, int row_lo, int rows_loc, int* u,
                 int* acc, const int* ctrl, ShardAbsorb* p) {
  if (!valid_rows(n, row_lo, rows_loc) ||
      !lattice_classes(classes, n_classes, n, &p->lattice))
    return false;
  p->pool.count = pool_size;
  for (int k = 0; k < gossip::kMaxImpPool; ++k) {
    p->pool.d[k] = k < pool_size ? offs[k] : 0;
    if (k < pool_size && (p->pool.d[k] < 1 || p->pool.d[k] >= n)) return false;
  }
  p->n = n;
  p->row_lo = row_lo;
  p->count = rows_loc * kChoiceLanes;
  p->u = u;
  p->acc = acc;
  p->ctrl = ctrl;
  return true;
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Each entry point queues one launch on `stream` of CUDA device `device`
// and returns its launch error (a cudaError_t), 0 if none. `mark` and
// `next` are the device's global int8 [R * 128] mark planes of this round
// and of the next; `words` its global uint32 [R * 128] directions words
// (ops/fused_imp.imp_dir_words); other global planes are [R * 128], a
// shard's own [rows_loc * 128]. (k1, k2, c1, c2) are the key and choice
// key of the round whose marks the launch writes: the prologue's own
// round, an absorb's next round. `classes` (the n_classes sorted lattice
// classes) and `offs` (the round's pool_size displacements) are host
// arrays, read here. u is int32[1], acc int32[2] zeroed once, ctrl the
// run's int32[2] (done, rounds) on this device. The push-sum absorb's
// `global` picks global termination's instance.

extern "C" int gossip_imp_hbm_shard_mark(
    int8_t* mark, const int* active, const uint32_t* words, unsigned k1,
    unsigned k2, unsigned c1, unsigned c2, int n_classes, int n, int pool_size,
    int row_lo, int rows, const int* ctrl, int device, void* stream_ptr) {
  static int grid_cache[64];
  MarkOut out;
  if (!valid_rows(n, row_lo, rows) || n_classes < 1 ||
      n_classes > gossip::kMaxDirs ||
      !make_marks(mark, words, k1, k2, c1, c2, pool_size, &out))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid =
      round_grid(imp_shard_prologue, rows * kChoiceLanes, device, grid_cache);
  imp_shard_prologue<<<grid, kBlock, 0, (cudaStream_t)stream_ptr>>>(
      out, active, n_classes, n, row_lo, rows * kChoiceLanes, ctrl);
  return (int)cudaGetLastError();
}

extern "C" int gossip_pushsum_imp_hbm_shard_absorb(
    const float* s_in, const float* w_in, float* s_out, float* w_out,
    const int* t_in, const int* c_in, int* t_out, int* c_out,
    const int8_t* mark, int8_t* next, const uint32_t* words, unsigned k1,
    unsigned k2, unsigned c1, unsigned c2, const int* classes, int n_classes,
    const int* offs, int pool_size, int n, int row_lo, int rows_loc,
    float delta, int term_rounds, int global, int* u, int* acc,
    const int* ctrl, int device, void* stream_ptr) {
  static int grid_cache[2][64];
  ShardAbsorb p;
  MarkOut out;
  if (!make_absorb(classes, n_classes, offs, pool_size, n, row_lo, rows_loc, u,
                   acc, ctrl, &p) ||
      !make_marks(next, words, k1, k2, c1, c2, pool_size, &out))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (global) {
    const int grid = round_grid(pushsum_imp_shard_absorb<true>, p.count,
                                device, grid_cache[1]);
    pushsum_imp_shard_absorb<true><<<grid, kBlock, 0, stream>>>(
        s_in, w_in, s_out, w_out, t_in, c_in, t_out, c_out, mark, out, p,
        delta, term_rounds);
  } else {
    const int grid = round_grid(pushsum_imp_shard_absorb<false>, p.count,
                                device, grid_cache[0]);
    pushsum_imp_shard_absorb<false><<<grid, kBlock, 0, stream>>>(
        s_in, w_in, s_out, w_out, t_in, c_in, t_out, c_out, mark, out, p,
        delta, term_rounds);
  }
  return (int)cudaGetLastError();
}

extern "C" int gossip_gossip_imp_hbm_shard_absorb(
    const int* n_in, const int* a_in, const int* c_in, int* n_out, int* a_out,
    int* c_out, const int8_t* mark, int8_t* next, const uint32_t* words,
    unsigned k1, unsigned k2, unsigned c1, unsigned c2, const int* classes,
    int n_classes, const int* offs, int pool_size, int n, int row_lo,
    int rows_loc, int rumor_target, int suppress, int* u, int* acc,
    const int* ctrl, int device, void* stream_ptr) {
  static int grid_cache[64];
  ShardAbsorb p;
  MarkOut out;
  if (!make_absorb(classes, n_classes, offs, pool_size, n, row_lo, rows_loc, u,
                   acc, ctrl, &p) ||
      !make_marks(next, words, k1, k2, c1, c2, pool_size, &out))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int grid =
      round_grid(gossip_imp_shard_absorb, p.count, device, grid_cache);
  gossip_imp_shard_absorb<<<grid, kBlock, 0, (cudaStream_t)stream_ptr>>>(
      n_in, a_in, c_in, n_out, a_out, c_out, mark, out, p, rumor_target,
      suppress);
  return (int)cudaGetLastError();
}
