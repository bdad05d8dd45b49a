// The telemetry plane's rows in the chunk kernels (ops/telemetry.py): what
// the telemetry instances of kernel A (csrc/scatter.cu), the pool kernels
// (csrc/fused_pool.cu, rows 1-2) and the whole-array lattice kernels
// (csrc/fused_resident.cu, rows 5-6) share.
//
// Replaces no Pallas kernel of its own: the JAX pool and stencil kernels
// fold one counter row a grid step into a VMEM register (ops/fused.py
// telemetry_row, ops/fused_pool.py:738-790, ops/fused.py:612-664), and its
// chunked engine computes the row with XLA reductions after every round
// (ops/telemetry.py make_row_fn, models/runner.py:2109-2140).
//
// Design: rows are observations, so no round waits for them. In each round
// every thread of a telemetry instance adds up, over the nodes it owns,
// the row's counts (converged, live, converged among the live, active,
// drop-gate firings, revivals, adversaries, and in kernel A's dup
// instances dup-gate firings) and float sums (the estimate
// error over converged nodes, w, and under global termination the error
// over every real node), from the state the round has just written; before
// the round's last grid barrier each block reduces them and writes its
// kPartials words for the round into a [rounds, blocks, kPartials] scratch
// (block_partials). After the chunk one small launch (rows_kernel, a warp a
// round) sums each round's partials in block order into the [rounds,
// kCols] float32 rows. What bounds it: the reduce reads rounds * blocks *
// 40 bytes and writes rounds * 40, a few microseconds; the instance's own
// cost is the per-node counting and the block reduction a round.
//
// The float sums run in one fixed order, so a row is the same on every run
// and the plain versions repeat it (ops/telemetry.KernelOrder): each thread
// adds its nodes in its visiting order from 0.0; a warp folds its 32 sums
// by halves (shuffle-down by 16, 8, 4, 2, 1); the block adds its warp sums
// in warp order from 0.0; the grid's partials are added with lane l taking
// blocks l, l + 32, ... from 0.0, then the lanes folded by halves
// (grid_sum, which kernel A's health sentinel uses for its in-round Σw
// too). Every add is flushed (csrc/faults.cuh flush), as XLA flushes on
// the CPU.
#pragma once

#include <math.h>
#include <stdint.h>

#include "faults.cuh"

namespace gossip {
namespace tele {

// The row's columns (ops/telemetry.py COLUMNS) and a block's partials.
constexpr int kCols = 10;
constexpr int kPartials = 11;
constexpr int kInts = 7;  // partials 0..6 are int32 counts, 7..9 float32 sums,
                          // 10 the dup count (kernel A's dup instances alone)
constexpr int kConv = 0;
constexpr int kLive = 1;
constexpr int kConvAlive = 2;
constexpr int kActive = 3;
constexpr int kDrops = 4;
constexpr int kRevived = 5;
constexpr int kByz = 6;
constexpr int kErr = 7;
constexpr int kW = 8;
constexpr int kErrAll = 9;
constexpr int kDups = 10;

// A node's estimate error |s / w - tmean|, each op flushed, in the form of
// the JAX row it follows: the chunked engine's (w = 0 reads as a ratio of
// 0; kernel A), the pool kernel's (w = 0 reads as w = 1) and the stencil
// kernel's (s / w as it is).
GOSSIP_HD float chunked_err(float s, float w, float tmean) {
  const float ratio = w != 0.0f ? flush(s / w) : 0.0f;
  return fabsf(flush(ratio - tmean));
}

GOSSIP_HD float pool_err(float s, float w, float tmean) {
  return fabsf(flush(flush(s / (w != 0.0f ? w : 1.0f)) - tmean));
}

GOSSIP_HD float stencil_err(float s, float w, float tmean) {
  return fabsf(flush(flush(s / w) - tmean));
}

// One thread's counts and sums over the nodes it owns in a round.
struct Acc {
  int i[kInts] = {0, 0, 0, 0, 0, 0, 0};
  float f[kDups - kInts] = {0.0f, 0.0f, 0.0f};
  int dups = 0;  // dup-gate firings among the live (kernel A's dup instances)

  GOSSIP_HD void add(int col, float v) {
    f[col - kInts] = flush(f[col - kInts] + v);
  }
};

// The row of round r from its column totals: conv, live (the population
// without a crash model), gap (need - conv among the live under one, else
// target - conv), active (gossip), mae = err / max(conv, 1) and mass = w -
// n_mass (push-sum), drops, dups, revived, byz.
GOSSIP_HD void assemble(const int* tot, const float* sum, int n_live,
                        int target, const int* needs, int r, int n_mass,
                        bool pushsum, float* row, int dups = 0) {
  const int conv = tot[kConv];
  const int live = needs != nullptr ? tot[kLive] : n_live;
  const int gap =
      needs != nullptr ? needs[r] - tot[kConvAlive] : target - conv;
  row[0] = (float)conv;
  row[1] = (float)live;
  row[2] = (float)gap;
  row[3] = pushsum ? 0.0f : (float)tot[kActive];
  row[4] = pushsum ? flush(sum[0] / (float)(conv > 1 ? conv : 1)) : 0.0f;
  row[5] = pushsum ? flush(sum[1] - (float)n_mass) : 0.0f;
  row[6] = (float)tot[kDrops];
  row[7] = (float)dups;
  row[8] = (float)tot[kRevived];
  row[9] = (float)tot[kByz];
}

#ifdef __CUDACC__

// A warp's 32 lane values folded by halves, flushed: valid in lane 0.
__device__ __forceinline__ float warp_fold(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = flush(v + __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// The sum of p[0 .. g) in the grid order, by one whole warp: lane l adds
// p[l], p[l + 32], ... from 0.0, then the lanes fold. Valid in lane 0. The
// partials come from other blocks, so they are read past L1.
__device__ __forceinline__ float grid_sum(const float* p, int g) {
  float acc = 0.0f;
  for (int b = threadIdx.x & 31; b < g; b += 32) acc = flush(acc + __ldcg(p + b));
  return warp_fold(acc);
}

// The block's partials from every thread's Acc, written by the block's
// first threads to out[0 .. kDups), and with Dups out[kDups] too: int
// counts in any order, float sums folded a warp at a time and added in
// warp order from 0.0. Ends with the block synchronized, so `out` is
// written before the round's barrier that follows.
template <int kBlockThreads, bool Dups = false>
__device__ inline void block_partials(const Acc& a, int* out) {
  constexpr int kWarps = kBlockThreads / 32;
  __shared__ int si[kWarps][kInts + (Dups ? 1 : 0)];
  __shared__ float sf[kWarps][kDups - kInts];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < kInts; ++c) {
    int v = a.i[c];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) si[warp][c] = v;
  }
  if constexpr (Dups) {
    int v = a.dups;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) si[warp][kInts] = v;
  }
#pragma unroll
  for (int c = 0; c < kDups - kInts; ++c) {
    const float v = warp_fold(a.f[c]);
    if (lane == 0) sf[warp][c] = v;
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < kInts) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += si[w][c];
    out[c] = t;
  } else if (Dups && c == kDups) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += si[w][kInts];
    out[kDups] = t;
  } else if (c < kDups) {
    float t = 0.0f;
    for (int w = 0; w < kWarps; ++w) t = flush(t + sf[w][c - kInts]);
    out[c] = __float_as_int(t);
  }
  __syncthreads();
}

// What the reduce of a chunk's rows needs.
struct RowArgs {
  const int* part;  // [rounds, grid, kPartials]
  const int* ctrl;  // the chunk's (done, rounds executed); under global
                    // termination done is the verdict's alone
  float* rows;      // [rounds, kCols]
  int grid, rounds;
  int n_live;  // the population: the live count without a crash model and
               // the converged count where global termination latched
  int target;
  const int* needs;  // the rounds' quorum needs; null without a crash model
  int n_mass;        // Σw's invariant: the population, or the padded plane
  int pushsum, global;
  int dups;  // whether the partials carry the dup count (kDups)
};

// One warp a round: the round's partials summed in block order into its
// row; rows of rounds the chunk did not execute are zero. Under global
// termination the round that ended the chunk counts every real node
// converged, with the error over all of them (the latch comes after the
// round's partials were written); a chunk that a sentinel's trip ended
// latches nothing.
__global__ void __launch_bounds__(32) rows_kernel(RowArgs a) {
  const int r = blockIdx.x;
  const int lane = threadIdx.x;
  float* row = a.rows + (size_t)r * kCols;
  const int executed = a.ctrl[1];
  if (r >= executed) {
    if (lane < kCols) row[lane] = 0.0f;
    return;
  }
  const int* p = a.part + (size_t)r * a.grid * kPartials;
  int tot[kInts];
#pragma unroll
  for (int c = 0; c < kInts; ++c) {
    int v = 0;
    for (int b = lane; b < a.grid; b += 32) v += p[(size_t)b * kPartials + c];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    tot[c] = v;
  }
  int dups = 0;
  if (a.dups) {
    for (int b = lane; b < a.grid; b += 32) dups += p[(size_t)b * kPartials + kDups];
    for (int o = 16; o > 0; o >>= 1) dups += __shfl_down_sync(0xffffffffu, dups, o);
  }
  float sum[kDups - kInts];
#pragma unroll
  for (int c = 0; c < kDups - kInts; ++c) {
    float v = 0.0f;
    for (int b = lane; b < a.grid; b += 32)
      v = flush(v + __int_as_float(p[(size_t)b * kPartials + kInts + c]));
    sum[c] = warp_fold(v);
  }
  if (lane == 0) {
    float err_w[2] = {sum[kErr - kInts], sum[kW - kInts]};
    if (a.global && a.ctrl[0] && r == executed - 1) {
      tot[kConv] = a.n_live;
      err_w[0] = sum[kErrAll - kInts];
    }
    float out[kCols];
    assemble(tot, err_w, a.n_live, a.target, a.needs, r, a.n_mass,
             a.pushsum != 0, out, dups);
    for (int c = 0; c < kCols; ++c) row[c] = out[c];
  }
}

// Queues rows_kernel for a chunk of `rounds` rounds.
inline cudaError_t queue_rows(const RowArgs& a, cudaStream_t stream) {
  if (a.rounds <= 0) return cudaSuccess;
  rows_kernel<<<a.rounds, 32, 0, stream>>>(a);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace tele
}  // namespace gossip
