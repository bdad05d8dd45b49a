// One round of the replicated-pool2 composition over one shard, push-sum
// and gossip, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's
// parallel/pool2_sharded.py: make_pushsum_pool2_shard_chunk (pallas_call at
// :591) and make_gossip_pool2_shard_chunk (pallas_call at :836). A shard
// owns global rows [row0, row0 + rows_loc) of the pool layout's [R, 128]
// planes; one launch advances them by one round of the streaming pool
// tier's trajectory (csrc/fused_pool2.cu):
//
//   inbox[j] = sum over slots k, in order from 0.0, of send[i] * [choice(i) == k]
//              with i = j - d_k if j >= d_k else j - d_k + n   (a mod-n roll)
//
// then the absorb with the term/conv latch (push-sum) or the receipt count
// with receiver-side suppression (gossip). The sources i lie anywhere in
// the population, so they are read from the round's delivered summary (the
// raw s and w planes, or the active plane), never from the shard's own
// planes: the whole gathered copy on the all_gather wire, or slot k's band
// at its start on the reduce_scatter wire (csrc/pool2.cuh, wire_index; the
// wires are parallel/halo.py's copies). The launch writes the shard's new
// planes and u, its converged count, to a device slot; a verdict launch
// (shard_verdict, csrc/chunk.cuh) sums the shards' slots into the run's
// done flag and round counter, and every launch returns at once once that
// flag is set.
//
// What bounds it on this card: memory traffic, as in csrc/fused_pool2.cu.
// A round over a shard reads and writes its state once (push-sum 12 bytes
// a node each way, gossip 8) and reads P source windows (push-sum s and w,
// 8 bytes a slot; gossip active, 4) from the summary: 40 bytes a node for
// push-sum at P = 2 and 24 for gossip.
//
// Design: csrc/fused_pool2.cu's round, with the sources moved to the wire.
// A thread owns the 8 destinations of one packed-word column (one lane, 8
// consecutive rows); under one slot their sources are one lane on 8
// consecutive rows, so two Threefry words give their pool choices,
// regenerated at the sources' global positions (column_sources). The
// source halves on the way in, before the slot sums, as the chunked engine
// and csrc/fused_pool2.cu do. Input and output planes are separate (the
// runner's ping/pong sets), so the round-start state stays readable, and a
// launch that finds the done flag set writes nothing. The converged count
// is summed per block and across blocks by a ticket, whose last block
// writes u and resets the shard's two accumulator words for the next
// launch. The absorb arithmetic and the numerics are csrc/chunk.cuh's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "pool2.cuh"
#include "threefry.cuh"

namespace {

using gossip::block_sum;
using gossip::finish_shard_count;
using gossip::kBlock;
using gossip::round_grid;
using gossip::pool2::column_sources;
using gossip::pool2::kLanes;
using gossip::pool2::kPack;
using gossip::pool2::local_column_origin;
using gossip::pool2::shard_column_origin;
using gossip::pool2::wire_index;

constexpr int kMaxPool = 16;

// One round's operands of one shard, passed by value.
struct ShardRound {
  uint32_t k1, k2;         // the round key
  int d[kMaxPool];         // the round's displacements
  int base[kMaxPool];      // each slot's summary start (csrc/pool2.cuh)
  int n, R, row0, n_cols, pool_size;
  int* u;                  // the shard's converged count
  int* acc;                // [2]: block total, ticket; zero between launches
  const int* ctrl;         // [2]: done, rounds
};

struct PushSumWire {
  const float* s[kMaxPool];
  const float* w[kMaxPool];
};

struct GossipWire {
  const int* active[kMaxPool];
};

__global__ void pushsum_pool2_shard_round(const float* s_in, const float* w_in,
                                          const int* tc_in, float* s_out,
                                          float* w_out, int* tc_out,
                                          PushSumWire wire, ShardRound p,
                                          float delta, int term_rounds) {
  if (p.ctrl[0]) return;
  int c = 0;
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < p.n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = shard_column_origin(col, p.row0);
    const int l0 = local_column_origin(col);
    float in_s[kPack], in_w[kPack];
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) in_s[sub] = in_w[sub] = 0.0f;
    for (int slot = 0; slot < p.pool_size; ++slot) {
      int src[kPack], ch[kPack];
      column_sources(j0, p.d[slot], p.n, p.k1, p.k2, p.pool_size, src, ch);
      const float* ws = wire.s[slot];
      const float* ww = wire.w[slot];
#pragma unroll
      for (int sub = 0; sub < kPack; ++sub) {
        const bool hit = ch[sub] == slot && j0 + sub * kLanes < p.n;
        const int at = wire_index(src[sub], p.row0, p.base[slot], p.R);
        in_s[sub] = in_s[sub] + (hit ? ws[at] * 0.5f : 0.0f);
        in_w[sub] = in_w[sub] + (hit ? ww[at] * 0.5f : 0.0f);
      }
    }
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int l = l0 + sub * kLanes;
      const bool pad = j0 + sub * kLanes >= p.n;
      const float s_t = s_in[l], w_t = w_in[l];
      const int tc = tc_in[l];
      float s_new, w_new;
      int t_new;
      const int cv = gossip::pushsum_absorb(
          s_t, w_t, [&] { return gossip::pool2::tc_term(tc); },
          [&] { return gossip::pool2::tc_conv(tc); }, pad, !pad, in_s[sub],
          in_w[sub], delta, term_rounds, s_new, w_new, t_new);
      s_out[l] = s_new;
      w_out[l] = w_new;
      tc_out[l] = gossip::pool2::tc_pack(t_new, cv != 0);
      c += cv;
    }
  }
  finish_shard_count(block_sum(c), p.acc, p.u);
}

__global__ void gossip_pool2_shard_round(const int* n_in, const int* a_in,
                                         int* n_out, int* a_out,
                                         GossipWire wire, ShardRound p,
                                         int rumor_target, int suppress) {
  if (p.ctrl[0]) return;
  int c = 0;
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < p.n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = shard_column_origin(col, p.row0);
    const int l0 = local_column_origin(col);
    int inbox[kPack];
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) inbox[sub] = 0;
    for (int slot = 0; slot < p.pool_size; ++slot) {
      int src[kPack], ch[kPack];
      column_sources(j0, p.d[slot], p.n, p.k1, p.k2, p.pool_size, src, ch);
      const int* wa = wire.active[slot];
#pragma unroll
      for (int sub = 0; sub < kPack; ++sub) {
        const bool hit = ch[sub] == slot && j0 + sub * kLanes < p.n;
        const int at = wire_index(src[sub], p.row0, p.base[slot], p.R);
        inbox[sub] += (hit && wa[at] != 0) ? 1 : 0;
      }
    }
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int l = l0 + sub * kLanes;
      const bool pad = j0 + sub * kLanes >= p.n;
      const int count = n_in[l];
      int cnt, act;
      c += gossip::gossip_absorb(
          [&] { return !pad && count >= rumor_target; }, [&] { return count; },
          [&] { return a_in[l]; }, pad, inbox[sub], rumor_target, suppress, cnt,
          act);
      n_out[l] = cnt;
      a_out[l] = act;
    }
  }
  finish_shard_count(block_sum(c), p.acc, p.u);
}

ShardRound make_round(const int* bases, const int* offs, unsigned k1,
                      unsigned k2, int n, int R, int row0, int rows_loc,
                      int pool_size, int* u, int* acc, const int* ctrl) {
  ShardRound p;
  p.k1 = k1;
  p.k2 = k2;
  for (int k = 0; k < kMaxPool; ++k) {
    p.d[k] = k < pool_size ? offs[k] : 0;
    p.base[k] = k < pool_size ? bases[k] : 0;
  }
  p.n = n;
  p.R = R;
  p.row0 = row0;
  p.n_cols = rows_loc / kPack * kLanes;
  p.pool_size = pool_size;
  p.u = u;
  p.acc = acc;
  p.ctrl = ctrl;
  return p;
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Each entry point queues one launch on `stream` of CUDA device `device`
// and returns its launch error (a cudaError_t), 0 if none. Planes are the
// shard's [rows_loc, 128]; `wire` is a host array of device pointers to
// each slot's delivered summary (push-sum: s of slot 0, w of slot 0, s of
// slot 1, ...; gossip: active of each slot), `bases` and `offs` host
// arrays of pool_size ints. u is int32[1], acc int32[2] zeroed once, ctrl
// the run's int32[2] (done, rounds) on this device.

extern "C" int gossip_pushsum_pool2_shard_round(
    const float* s_in, const float* w_in, const int* tc_in, float* s_out,
    float* w_out, int* tc_out, const void* const* wire, const int* bases,
    const int* offs, unsigned k1, unsigned k2, int n, int R, int row0,
    int rows_loc, int pool_size, float delta, int term_rounds, int* u,
    int* acc, const int* ctrl, int device, void* stream_ptr) {
  static int grid_cache[64];
  if (pool_size < 1 || pool_size > kMaxPool) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ShardRound p = make_round(bases, offs, k1, k2, n, R, row0, rows_loc,
                                  pool_size, u, acc, ctrl);
  PushSumWire w;
  for (int k = 0; k < kMaxPool; ++k) {
    w.s[k] = k < pool_size ? (const float*)wire[2 * k] : nullptr;
    w.w[k] = k < pool_size ? (const float*)wire[2 * k + 1] : nullptr;
  }
  const int grid = round_grid(pushsum_pool2_shard_round, p.n_cols, device, grid_cache);
  pushsum_pool2_shard_round<<<grid, kBlock, 0, (cudaStream_t)stream_ptr>>>(
      s_in, w_in, tc_in, s_out, w_out, tc_out, w, p, delta, term_rounds);
  return (int)cudaGetLastError();
}

extern "C" int gossip_gossip_pool2_shard_round(
    const int* n_in, const int* a_in, int* n_out, int* a_out,
    const void* const* wire, const int* bases, const int* offs, unsigned k1,
    unsigned k2, int n, int R, int row0, int rows_loc, int pool_size,
    int rumor_target, int suppress, int* u, int* acc, const int* ctrl,
    int device, void* stream_ptr) {
  static int grid_cache[64];
  if (pool_size < 1 || pool_size > kMaxPool) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const ShardRound p = make_round(bases, offs, k1, k2, n, R, row0, rows_loc,
                                  pool_size, u, acc, ctrl);
  GossipWire w;
  for (int k = 0; k < kMaxPool; ++k)
    w.active[k] = k < pool_size ? (const int*)wire[k] : nullptr;
  const int grid = round_grid(gossip_pool2_shard_round, p.n_cols, device, grid_cache);
  gossip_pool2_shard_round<<<grid, kBlock, 0, (cudaStream_t)stream_ptr>>>(
      n_in, a_in, n_out, a_out, w, p, rumor_target, suppress);
  return (int)cudaGetLastError();
}

extern "C" int gossip_pool2_shard_verdict(const int* u, int shards, int target,
                                          int* ctrl, int device,
                                          void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // A super-step is one round; u holds one count per shard.
  gossip::shard_verdict<<<1, 1, 0, (cudaStream_t)stream_ptr>>>(
      u, 1, shards, 0, 1, target, ctrl);
  return (int)cudaGetLastError();
}
