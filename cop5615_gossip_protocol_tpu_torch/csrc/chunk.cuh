// What the chunk kernels of csrc/fused_pool.cu, csrc/fused_pool2.cu,
// csrc/fused_stencil.cu, csrc/fused_imp.cu and csrc/fused_resident.cu
// share: the launch geometry, the converged count and done flag (and their
// faulted forms: the live count's seed verdict, the quorum and global
// verdicts), the state planes, the init and finish launches and the
// per-node absorb of each protocol; and the device-side verdict of the
// sharded compositions (csrc/fused_pool2_shard.cu,
// csrc/fused_stencil_shard.cu, csrc/fused_imp_hbm_shard.cu) with their
// shard launches' count and grid.
//
// A chunk keeps its control words in `ctrl` (int32[2]: done, rounds
// executed) and `scratch` (int32[2 * (rounds + 1)]: per-launch totals, then
// tickets), both zeroed by the caller. The init launch copies the input
// planes into the A planes and seeds the done flag from the incoming conv
// plane; every later launch first reads the done flag and returns at once
// when it is set, so a launch after convergence writes nothing and a chunk
// from a converged state runs 0 rounds. A chunk that keeps its state in
// ping/pong planes A and B ends with a finish launch that copies B into A
// when it executed an odd number of rounds, so the result is always in A.
//
// Numerics: the kernels are built without fast math, with -fmad=false and
// denormals kept (utils/kernels.py), so (s - s * 0.5) + inbox and s / w
// round exactly as the chunked engines do. The push-sum instances that
// carry crash-stop (their faulted instances here and in csrc/scatter.cu and
// csrc/fused_pool2_shard.cu) flush where the JAX package's compiled round
// flushes: each half sent, each kept half, each inbox add and each absorbed
// sum, through csrc/faults.cuh's flush and keep_flushed (pushsum_absorb's
// Flush). Only a crash drains mass below FLT_MIN, and global termination
// refuses crashes, so the fault-free instances and the global-only ones
// (rows 7, 9, 11, 13, 15, 16, 18) never meet a value the flush would change
// and keep their code.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "faults.cuh"

namespace gossip {

constexpr int kBlock = 256;

// Blocks for a grid-stride launch of `kernel` over `work` elements: as many
// as the SMs hold at once (registers permitting), so every block runs in
// the first wave and a launch that returns at once costs a few µs.
template <typename Kernel>
int grid_for(Kernel kernel, long long work, int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock,
                                                    0) != cudaSuccess ||
      sms <= 0 || per_sm <= 0) {
    sms = 132;
    per_sm = 1;
  }
  const long long want = (work + kBlock - 1) / kBlock;
  const long long cap = (long long)sms * per_sm;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

// Sum of v over the block, valid in thread 0.
__device__ inline int block_sum(int v) {
  __shared__ int warp_sums[kBlock / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0;
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_sums[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// Adds the block's converged count to *total; the last block of the grid
// to arrive sets ctrl[0] (done) from the grand total and, for a protocol
// round, bumps ctrl[1] (rounds executed, whose parity names the current
// ping/pong planes). Every other block read ctrl before it took its
// ticket, so the write races with no reader.
__device__ inline void finish_count(int block_count, int* total,
                                    unsigned* ticket, int* ctrl, int target,
                                    bool count_round) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    atomicAdd(total, block_count);
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    const int grand = atomicAdd(total, 0);
    if (count_round) ctrl[1] += 1;
    ctrl[0] = grand >= target ? 1 : 0;
  }
}

// Planes of one state set, passed by value.
struct PushSumPlanes {
  float* s;
  float* w;
  int* term;
  int* conv;
};

struct GossipPlanes {
  int* count;
  int* active;
  int* conv;
};

// One node's push-sum absorb: its own halved send leaves (`sends`), the
// inbox sums arrive, and the term/conv latch moves on a round it received
// something. Takes the round-start s_t, w_t and reads the node's term and
// conv flag through `term_of()` and `conv_of()` where the arithmetic needs
// them (so each caller keeps its own plane layout and load order); sets
// s_new, w_new, t_new and returns the new conv flag (0 on pad lanes).
// Flush (the faulted instances): the kept halves and the sums flushed as
// the plain round flushes them (csrc/faults.cuh keep_flushed, with FoldS).
template <bool Flush = false, bool FoldS = true, typename TermOf,
          typename ConvOf>
__device__ __forceinline__ int pushsum_absorb(float s_t, float w_t, TermOf term_of,
                                              ConvOf conv_of, bool pad, bool sends,
                                              float in_s, float in_w, float delta,
                                              int term_rounds, float& s_new,
                                              float& w_new, int& t_new) {
  if constexpr (Flush) {
    float s_keep, w_keep;
    keep_flushed<FoldS>(s_t, w_t, sends, s_keep, w_keep);
    s_new = flush(s_keep + in_s);
    w_new = flush(w_keep + in_w);
  } else {
    const float s_send = sends ? s_t * 0.5f : 0.0f;
    const float w_send = sends ? w_t * 0.5f : 0.0f;
    s_new = (s_t - s_send) + in_s;
    w_new = (w_t - w_send) + in_w;
  }
  const bool received = in_w > 0.0f;
  const bool stable = fabsf(s_new / w_new - s_t / w_t) <= delta;
  const int t_old = term_of();
  t_new = received ? (stable ? t_old + 1 : 0) : t_old;
  return pad ? 0 : ((conv_of() || t_new >= term_rounds) ? 1 : 0);
}

// One node's gossip absorb with receiver-side suppression: reads its
// round-start conv flag, count and active flag through `conv_of()`,
// `count_of()` and `active_of()` where needed; sets cnt and act and returns
// the new conv flag (0 on pad lanes).
template <typename ConvOf, typename CountOf, typename ActiveOf>
__device__ __forceinline__ int gossip_absorb(ConvOf conv_of, CountOf count_of,
                                             ActiveOf active_of, bool pad, int inbox,
                                             int rumor_target, int suppress,
                                             int& cnt, int& act) {
  if (suppress && conv_of()) inbox = 0;
  cnt = count_of() + inbox;
  act = (active_of() != 0 || inbox > 0) ? 1 : 0;
  return (!pad && cnt >= rumor_target) ? 1 : 0;
}

// Receiver j's push-sum absorb (pushsum_absorb) between plane sets: reads
// j's round-start values from `cur`, writes `nxt` (which may be `cur`);
// returns j's new conv flag.
__device__ __forceinline__ int pushsum_absorb_node(
    const PushSumPlanes& cur, const PushSumPlanes& nxt, int j, bool pad,
    bool sends, float in_s, float in_w, float delta, int term_rounds) {
  float s_new, w_new;
  int t_new;
  const int cv = pushsum_absorb(
      cur.s[j], cur.w[j], [&] { return cur.term[j]; },
      [&] { return cur.conv[j] != 0; }, pad, sends, in_s, in_w, delta,
      term_rounds, s_new, w_new, t_new);
  nxt.s[j] = s_new;
  nxt.w[j] = w_new;
  nxt.term[j] = t_new;
  nxt.conv[j] = cv;
  return cv;
}

// Receiver j's push-sum absorb under global termination (absorb_global)
// between plane sets: term and conv stay. Returns 1 when j is a real node
// whose ratio moved more than the global rule allows, else 0.
__device__ __forceinline__ int pushsum_absorb_global_node(
    const PushSumPlanes& cur, const PushSumPlanes& nxt, int j, bool pad,
    bool sends, float in_s, float in_w, float delta) {
  float s_new, w_new;
  const bool unstable = absorb_global(cur.s[j], cur.w[j], pad, sends, in_s,
                                      in_w, delta, s_new, w_new);
  nxt.s[j] = s_new;
  nxt.w[j] = w_new;
  nxt.term[j] = cur.term[j];
  nxt.conv[j] = cur.conv[j];
  return unstable ? 1 : 0;
}

// Receiver j's gossip absorb (gossip_absorb) between plane sets; the same
// contract as pushsum_absorb_node.
__device__ __forceinline__ int gossip_absorb_node(const GossipPlanes& cur,
                                                  const GossipPlanes& nxt,
                                                  int j, bool pad, int inbox,
                                                  int rumor_target,
                                                  int suppress) {
  int cnt, act;
  const int cv = gossip_absorb(
      [&] { return cur.conv[j] != 0; }, [&] { return cur.count[j]; },
      [&] { return cur.active[j]; }, pad, inbox, rumor_target, suppress, cnt, act);
  nxt.count[j] = cnt;
  nxt.active[j] = act;
  nxt.conv[j] = cv;
  return cv;
}

__global__ void pushsum_init(const float* __restrict__ s0,
                             const float* __restrict__ w0,
                             const int* __restrict__ t0,
                             const int* __restrict__ c0, PushSumPlanes a,
                             int n_pad, int* total, unsigned* ticket,
                             int* ctrl, int target) {
  int c = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    a.s[j] = s0[j];
    a.w[j] = w0[j];
    a.term[j] = t0[j];
    a.conv[j] = c0[j];
    c += c0[j];
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, false);
}

__global__ void pushsum_finish(PushSumPlanes a, PushSumPlanes b, int n_pad,
                               const int* __restrict__ ctrl) {
  if (!(ctrl[1] & 1)) return;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    a.s[j] = b.s[j];
    a.w[j] = b.w[j];
    a.term[j] = b.term[j];
    a.conv[j] = b.conv[j];
  }
}

// The finish launch of a push-sum chunk under global termination
// (csrc/fused_stencil.cu, csrc/fused_imp.cu): pushsum_finish, and where the
// chunk's rounds ended in the global verdict (done with a round executed;
// a chunk done at its init launch runs none) conv latched on every real
// node (j < n) of the result, pad lanes 0.
__global__ void pushsum_finish_latch(PushSumPlanes a, PushSumPlanes b, int n,
                                     int n_pad, const int* __restrict__ ctrl) {
  const bool odd = (ctrl[1] & 1) != 0;
  const bool latch = ctrl[0] && ctrl[1] > 0;
  if (!odd && !latch) return;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    if (odd) {
      a.s[j] = b.s[j];
      a.w[j] = b.w[j];
      a.term[j] = b.term[j];
    }
    a.conv[j] = latched_conv(latch, j, n, odd ? b.conv[j] : a.conv[j]);
  }
}

__global__ void gossip_init(const int* __restrict__ n0,
                            const int* __restrict__ a0,
                            const int* __restrict__ c0, GossipPlanes a,
                            int n_pad, int* total, unsigned* ticket, int* ctrl,
                            int target) {
  int c = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    a.count[j] = n0[j];
    a.active[j] = a0[j];
    a.conv[j] = c0[j];
    c += c0[j];
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, false);
}

__global__ void gossip_finish(GossipPlanes a, GossipPlanes b, int n_pad,
                              const int* __restrict__ ctrl) {
  if (!(ctrl[1] & 1)) return;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    a.count[j] = b.count[j];
    a.active[j] = b.active[j];
    a.conv[j] = b.conv[j];
  }
}

// The chunk kernels' faulted init launches (csrc/fused_pool.cu,
// csrc/fused_resident.cu): the input into A, and the done flag seeded from
// the input's converged live count at `seed_round` (the round before the
// chunk) against `target` (that round's quorum need); `death` is the death
// plane over the padded layout (pad lanes 0), `revive` the revival plane
// (pad lanes never; null: crash-stop).
__global__ void pushsum_init_live(const float* __restrict__ s0,
                                  const float* __restrict__ w0,
                                  const int* __restrict__ t0,
                                  const int* __restrict__ c0, PushSumPlanes a,
                                  int n_pad, const int* death,
                                  const int* revive, int seed_round,
                                  int* total, unsigned* ticket, int* ctrl,
                                  int target) {
  int converged = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    a.s[j] = s0[j];
    a.w[j] = w0[j];
    a.term[j] = t0[j];
    a.conv[j] = c0[j];
    if (node_alive(death, revive, j, seed_round)) converged += c0[j];
  }
  finish_count(block_sum(converged), total, ticket, ctrl, target, false);
}

__global__ void gossip_init_live(const int* __restrict__ n0,
                                 const int* __restrict__ a0,
                                 const int* __restrict__ c0, GossipPlanes a,
                                 int n_pad, const int* death,
                                 const int* revive, int seed_round,
                                 int* total, unsigned* ticket, int* ctrl,
                                 int target) {
  int converged = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    a.count[j] = n0[j];
    a.active[j] = a0[j];
    a.conv[j] = c0[j];
    if (node_alive(death, revive, j, seed_round)) converged += c0[j];
  }
  finish_count(block_sum(converged), total, ticket, ctrl, target, false);
}

// finish_count's verdict under the failure model (the streaming pool
// kernels' faulted rounds, csrc/fused_pool2.cu, and the global instances of
// csrc/fused_stencil.cu and csrc/fused_imp.cu): the grand total against
// the round's quorum need (*need, where need is not null) or the target;
// under global termination (`global`) the total is the round's unstable
// count, and the round with none is done.
__device__ inline void finish_verdict(int block_count, int* total,
                                      unsigned* ticket, int* ctrl, int target,
                                      const int* need, bool global) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    atomicAdd(total, block_count);
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    const int grand = atomicAdd(total, 0);
    ctrl[1] += 1;
    ctrl[0] = (global ? grand == 0 : grand >= (need ? *need : target)) ? 1 : 0;
  }
}

// A shard launch's converged count: adds the block's count to acc[0]; the
// grid's last block writes the shard's total to *u and zeroes acc (the
// shard's two accumulator words) for the next launch.
__device__ inline void finish_shard_count(int block_count, int* acc, int* u) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    atomicAdd(&acc[0], block_count);
    __threadfence();
    last = atomicAdd((unsigned*)&acc[1], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    *u = atomicExch(&acc[0], 0);
    atomicExch(&acc[1], 0);
  }
}

// Blocks for a shard launch over `work` elements: grid_for, with the SMs'
// capacity asked once per kernel and device (`cache`, one int per device),
// since a shard's round is a launch or two and the query would otherwise
// cost every launch.
template <typename Kernel>
int round_grid(Kernel kernel, long long work, int device, int* cache) {
  if (device < 0 || device >= 64) return grid_for(kernel, work, device);
  if (cache[device] == 0) cache[device] = grid_for(kernel, 1LL << 40, device);
  const long long want = (work + kBlock - 1) / kBlock;
  return (int)(want < cache[device] ? (want > 0 ? want : 1) : cache[device]);
}

// A sharded super-step's verdict, one thread: unless the run is done
// (ctrl[0]), count the super-step's `executed` rounds in ctrl[1] and set
// done once the shards' counts u[s * stride + index] sum to the target.
__global__ void shard_verdict(const int* u, int stride, int shards, int index,
                              int executed, int target, int* ctrl) {
  if (ctrl[0]) return;
  long long total = 0;
  for (int s = 0; s < shards; ++s) total += u[s * stride + index];
  ctrl[1] += executed;
  ctrl[0] = total >= target ? 1 : 0;
}

}  // namespace gossip
