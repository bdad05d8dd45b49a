// Streaming offset-pool push-sum and gossip chunks on the implicit full
// topology past the L2, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's
// ops/fused_pool2.py: make_pushsum_pool2_chunk (pallas_call at :952) and
// make_gossip_pool2_chunk (pallas_call at :1388). They compute the
// trajectory of the pool tier (csrc/fused_pool.cu) on the same [rows, 128]
// layout, for populations up to 2**27:
//
//   inbox[j] = sum over slots k, in order from 0.0, of send[i] * [choice(i) == k]
//              with i = j - d_k if j >= d_k else j - d_k + n   (a mod-n roll)
//
// then the absorb with the term/conv latch (push-sum) or the receipt count
// with receiver-side suppression (gossip), and a done flag that stops the
// chunk once the converged count reaches the target. Pad lanes (j >= n)
// never send and never receive.
//
// What bounds it on this card: memory traffic. Past 2**21 nodes the state
// no longer fits the 50 MB L2 (push-sum is 12 bytes a node each way), so
// every round streams it from HBM: the state read and written once plus P
// source windows (push-sum s and w, 8 bytes a slot; gossip active, 4), 40
// bytes a node a round for push-sum at P = 2 and 24 for gossip, 0.2 and
// 0.12 ms a round at 16.8M nodes at 3.35 TB/s. The arithmetic is small
// beside it (a quarter of a Threefry per node per slot and a dozen float
// operations).
//
// Design: one launch a round and no send planes. The state lives in
// ping/pong plane sets A and B; round r reads parity r % 2 and writes the
// other, so the round-start state is immutable while it is read, and each
// destination reads its sources straight from it, halving on the way in.
// Push-sum packs term and conv into one int32 plane (csrc/pool2.cuh) and
// gossip stores only count and active (conv is count >= rumor_target, by
// monotonicity), so a round moves 12 and 8 state bytes a node each way. The
// pool choice of each source is regenerated from the round key where it is
// read, never stored: a thread owns the 8 destinations of one packed-word
// column, whose sources under one slot share a lane on 8 consecutive rows,
// so 2 Threefry words serve them (P / 4 words a node, not P); only the
// column the mod-n wrap cuts through draws a word per source. Neighbouring
// threads own neighbouring lanes, so every gather of a warp reads 32
// consecutive words. A chunk is an init launch (packs the input into A and
// seeds the done flag), one launch per round and a finish launch (unpacks
// the final parity into the output planes), queued with no host sync;
// every launch first reads the done flag and returns at once when it is
// set. Grids are grid-stride, sized to what the SMs hold at once. The
// absorb arithmetic and the numerics are csrc/chunk.cuh's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "pool2.cuh"
#include "threefry.cuh"

namespace {

using gossip::block_sum;
using gossip::finish_count;
using gossip::grid_for;
using gossip::kBlock;
using gossip::pool2::column_sources;
using gossip::pool2::kLanes;
using gossip::pool2::kPack;
using gossip::pool2::local_column_origin;

struct PushSumPool2 {
  float* s;
  float* w;
  int* tc;  // term | conv << 30
};

struct GossipPool2 {
  int* count;
  int* active;
};

// ---------------------------------------------------------------- push-sum

__global__ void pushsum_pool2_init(const float* __restrict__ s0,
                                   const float* __restrict__ w0,
                                   const int* __restrict__ t0,
                                   const int* __restrict__ c0, PushSumPool2 a,
                                   int n_pad, int* total, unsigned* ticket,
                                   int* ctrl, int target) {
  int c = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool cv = c0[j] != 0;
    a.s[j] = s0[j];
    a.w[j] = w0[j];
    a.tc[j] = gossip::pool2::tc_pack(t0[j], cv);
    c += cv ? 1 : 0;
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, false);
}

__global__ void pushsum_pool2_round(PushSumPool2 cur, PushSumPool2 nxt,
                                    const long long* __restrict__ key,
                                    const int* __restrict__ offs, int n,
                                    int n_cols, int pool_size, float delta,
                                    int term_rounds, int target, int* total,
                                    unsigned* ticket, int* ctrl) {
  if (ctrl[0]) return;
  const uint32_t k1 = (uint32_t)key[0], k2 = (uint32_t)key[1];
  int c = 0;
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = local_column_origin(col);
    float in_s[kPack], in_w[kPack];
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) in_s[sub] = in_w[sub] = 0.0f;
    for (int slot = 0; slot < pool_size; ++slot) {
      int src[kPack], ch[kPack];
      column_sources(j0, offs[slot], n, k1, k2, pool_size, src, ch);
#pragma unroll
      for (int sub = 0; sub < kPack; ++sub) {
        const bool hit = ch[sub] == slot && j0 + sub * kLanes < n;
        in_s[sub] = in_s[sub] + (hit ? cur.s[src[sub]] * 0.5f : 0.0f);
        in_w[sub] = in_w[sub] + (hit ? cur.w[src[sub]] * 0.5f : 0.0f);
      }
    }
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int j = j0 + sub * kLanes;
      const bool pad = j >= n;
      const float s_t = cur.s[j], w_t = cur.w[j];
      const int tc = cur.tc[j];
      float s_new, w_new;
      int t_new;
      const int cv = gossip::pushsum_absorb(
          s_t, w_t, [&] { return gossip::pool2::tc_term(tc); },
          [&] { return gossip::pool2::tc_conv(tc); }, pad, !pad, in_s[sub], in_w[sub],
          delta, term_rounds, s_new, w_new, t_new);
      nxt.s[j] = s_new;
      nxt.w[j] = w_new;
      nxt.tc[j] = gossip::pool2::tc_pack(t_new, cv != 0);
      c += cv;
    }
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, true);
}

__global__ void pushsum_pool2_finish(PushSumPool2 a, PushSumPool2 b, float* s,
                                     float* w, int* term, int* conv, int n_pad,
                                     const int* __restrict__ ctrl) {
  const PushSumPool2 x = (ctrl[1] & 1) ? b : a;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const int tc = x.tc[j];
    s[j] = x.s[j];
    w[j] = x.w[j];
    term[j] = gossip::pool2::tc_term(tc);
    conv[j] = gossip::pool2::tc_conv(tc) ? 1 : 0;
  }
}

// ------------------------------------------------------------------ gossip

__global__ void gossip_pool2_init(const int* __restrict__ n0,
                                  const int* __restrict__ a0, GossipPool2 a,
                                  int n, int n_pad, int rumor_target,
                                  int* total, unsigned* ticket, int* ctrl,
                                  int target) {
  int c = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    a.count[j] = n0[j];
    a.active[j] = a0[j];
    c += (j < n && n0[j] >= rumor_target) ? 1 : 0;
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, false);
}

__global__ void gossip_pool2_round(GossipPool2 cur, GossipPool2 nxt,
                                   const long long* __restrict__ key,
                                   const int* __restrict__ offs, int n,
                                   int n_cols, int pool_size, int rumor_target,
                                   int suppress, int target, int* total,
                                   unsigned* ticket, int* ctrl) {
  if (ctrl[0]) return;
  const uint32_t k1 = (uint32_t)key[0], k2 = (uint32_t)key[1];
  int c = 0;
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = local_column_origin(col);
    int inbox[kPack];
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) inbox[sub] = 0;
    for (int slot = 0; slot < pool_size; ++slot) {
      int src[kPack], ch[kPack];
      column_sources(j0, offs[slot], n, k1, k2, pool_size, src, ch);
#pragma unroll
      for (int sub = 0; sub < kPack; ++sub) {
        const bool hit = ch[sub] == slot && j0 + sub * kLanes < n;
        inbox[sub] += (hit && cur.active[src[sub]] != 0) ? 1 : 0;
      }
    }
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int j = j0 + sub * kLanes;
      const bool pad = j >= n;
      const int count = cur.count[j];
      int cnt, act;
      c += gossip::gossip_absorb(
          [&] { return !pad && count >= rumor_target; }, [&] { return count; },
          [&] { return cur.active[j]; }, pad, inbox[sub], rumor_target, suppress,
          cnt, act);
      nxt.count[j] = cnt;
      nxt.active[j] = act;
    }
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, true);
}

__global__ void gossip_pool2_finish(GossipPool2 a, GossipPool2 b, int* count,
                                    int* active, int* conv, int n, int n_pad,
                                    int rumor_target,
                                    const int* __restrict__ ctrl) {
  const GossipPool2 x = (ctrl[1] & 1) ? b : a;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const int cnt = x.count[j];
    count[j] = cnt;
    active[j] = x.active[j];
    conv[j] = (j < n && cnt >= rumor_target) ? 1 : 0;
  }
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Both entry points queue the init launch, one launch per round and the
// finish launch on `stream` of CUDA device `device`, and return the first
// launch error (a cudaError_t), 0 if none. Outputs, the ping/pong planes
// (A, B: [n_pad] each) and scratch are allocated by the caller: ctrl is
// int32[2] (done, rounds executed) and scratch int32[2 * (rounds + 1)]
// (per-launch totals, then tickets), both zeroed. The inputs are read only
// by the init launch.

extern "C" int gossip_pushsum_pool2_chunk(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* sA, float* wA, int* tcA, float* sB,
    float* wB, int* tcB, const long long* keys, const int* offs, int* ctrl,
    int* scratch, int n, int n_pad, int pool_size, int rounds, float delta,
    int term_rounds, int target, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  const PushSumPool2 a{sA, wA, tcA}, b{sB, wB, tcB};
  const int n_cols = n_pad / kPack;
  pushsum_pool2_init<<<grid_for(pushsum_pool2_init, n_pad, device), kBlock, 0,
                       stream>>>(s0, w0, t0, c0, a, n_pad, totals + rounds,
                                 tickets + rounds, ctrl, target);
  err = cudaGetLastError();
  const int grid = grid_for(pushsum_pool2_round, n_cols, device);
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    pushsum_pool2_round<<<grid, kBlock, 0, stream>>>(
        r & 1 ? b : a, r & 1 ? a : b, keys + 2 * r, offs + r * pool_size, n,
        n_cols, pool_size, delta, term_rounds, target, totals + r, tickets + r,
        ctrl);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  pushsum_pool2_finish<<<grid_for(pushsum_pool2_finish, n_pad, device), kBlock,
                         0, stream>>>(a, b, s, w, term, conv, n_pad, ctrl);
  return (int)cudaGetLastError();
}

extern "C" int gossip_gossip_pool2_chunk(
    const int* n0, const int* a0, int* count, int* active, int* conv,
    int* nA, int* aA, int* nB, int* aB, const long long* keys, const int* offs,
    int* ctrl, int* scratch, int n, int n_pad, int pool_size, int rounds,
    int rumor_target, int suppress, int target, int device,
    void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  const GossipPool2 a{nA, aA}, b{nB, aB};
  const int n_cols = n_pad / kPack;
  gossip_pool2_init<<<grid_for(gossip_pool2_init, n_pad, device), kBlock, 0,
                      stream>>>(n0, a0, a, n, n_pad, rumor_target,
                                totals + rounds, tickets + rounds, ctrl, target);
  err = cudaGetLastError();
  const int grid = grid_for(gossip_pool2_round, n_cols, device);
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    gossip_pool2_round<<<grid, kBlock, 0, stream>>>(
        r & 1 ? b : a, r & 1 ? a : b, keys + 2 * r, offs + r * pool_size, n,
        n_cols, pool_size, rumor_target, suppress, target, totals + r,
        tickets + r, ctrl);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  gossip_pool2_finish<<<grid_for(gossip_pool2_finish, n_pad, device), kBlock, 0,
                        stream>>>(a, b, count, active, conv, n, n_pad,
                                  rumor_target, ctrl);
  return (int)cudaGetLastError();
}
