// One round of the replicated-pool2 composition over the rows one device
// owns, push-sum and gossip, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's
// parallel/pool2_sharded.py: make_pushsum_pool2_shard_chunk (pallas_call at
// :591) and make_gossip_pool2_shard_chunk (pallas_call at :836). The
// composition places a device's shards on consecutive rows, so a device
// owns global rows [row0, row0 + rows) of the pool layout's [R, 128]
// planes; one launch advances all of them by one round of the streaming
// pool tier's trajectory (csrc/fused_pool2.cu):
//
//   inbox[j] = sum over slots k, in order from 0.0, of send[i] * [choice(i) == k]
//              with i = j - d_k if j >= d_k else j - d_k + n   (a mod-n roll)
//
// then the absorb with the term/conv latch (push-sum) or the receipt count
// with receiver-side suppression (gossip).
//
// What bounds it on this card: memory traffic, as in csrc/fused_pool2.cu.
// A round reads and writes the device's state once (push-sum 12 bytes a
// node each way, gossip 8) and reads P source windows (push-sum s and w,
// 8 bytes a slot; gossip active, 4): 40 bytes a node for push-sum at P = 2
// and 24 for gossip.
//
// Design: csrc/fused_pool2.cu's round over the device's rows, with the
// sources read in place. The planes other nodes read (push-sum s and w,
// gossip active) are the device's global [R, 128] copies, one set per
// round parity: a destination's own values and every source sit at their
// global flat index (csrc/pool2.cuh, slot_reads), so the gather holds no
// modulo and, with every shard on one card, nothing is copied between
// rounds; the device's rows of the output set are, in place, the next
// round's summary. The planes only the node reads (push-sum's packed
// term|conv, gossip's count) hold the device's rows alone. Input and
// output sets are separate (the runner's ping/pong sets), so the
// round-start state stays readable and a round queued past a deferred
// verdict never changes the state the verdict names. A thread owns the 8
// destinations of one packed-word column; two Threefry words give their
// sources' pool choices under one slot (column_sources), regenerated at
// the sources' global positions, and each source halves on the way in,
// before the slot sums. The round's key and displacements are read from
// the device's copy of the chunk's streams. The converged count is summed
// per block and across blocks by a ticket in two accumulator words that
// the last block resets; that block either writes the device's count u,
// for the run's verdict when shards lie on several devices, or, when every
// shard is on this device (u null), takes the verdict itself: it counts
// the round in ctrl[1] and sets the done flag ctrl[0] once the count
// reaches the target. Every launch returns at once when it finds the done
// flag set, so it then writes nothing. The absorb arithmetic and the
// numerics are csrc/chunk.cuh's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "pool2.cuh"
#include "threefry.cuh"

namespace {

using gossip::block_sum;
using gossip::kBlock;
using gossip::round_grid;
using gossip::pool2::kLanes;
using gossip::pool2::kPack;
using gossip::pool2::local_column_origin;
using gossip::pool2::shard_column_origin;
using gossip::pool2::slot_reads;

// One device's round operands, passed by value.
struct DeviceRound {
  const long long* key;  // the round's key (two uint32 words)
  const int* offs;       // the round's pool_size displacements
  int n, row0, n_cols, pool_size;
  int* u;                // the device's converged count; null: verdict here
  int* acc;              // [2]: block total, ticket; zero between launches
  int* ctrl;             // [2]: done, rounds (this device's copy)
  int target;
};

// The launch's converged count: adds the block's count to acc[0]; the
// grid's last block resets acc and writes the total to *u or, without u,
// counts the round and sets the done flag from it. Every other block read
// ctrl before it took its ticket, so the write races with no reader.
__device__ inline void finish_round(int block_count, const DeviceRound& p) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    atomicAdd(&p.acc[0], block_count);
    __threadfence();
    last = atomicAdd((unsigned*)&p.acc[1], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    const int total = atomicExch(&p.acc[0], 0);
    atomicExch(&p.acc[1], 0);
    if (p.u != nullptr) {
      *p.u = total;
    } else {
      p.ctrl[1] += 1;
      p.ctrl[0] = total >= p.target ? 1 : 0;
    }
  }
}

__global__ void pushsum_pool2_shard_round(const float* __restrict__ s_in,
                                          const float* __restrict__ w_in,
                                          const int* __restrict__ tc_in,
                                          float* s_out, float* w_out,
                                          int* tc_out, DeviceRound p,
                                          float delta, int term_rounds) {
  if (p.ctrl[0]) return;
  const uint32_t k1 = (uint32_t)p.key[0], k2 = (uint32_t)p.key[1];
  int c = 0;
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < p.n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = shard_column_origin(col, p.row0);
    const int l0 = local_column_origin(col);
    float in_s[kPack], in_w[kPack];
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) in_s[sub] = in_w[sub] = 0.0f;
    for (int slot = 0; slot < p.pool_size; ++slot) {
      int at[kPack];
      bool hit[kPack];
      slot_reads(j0, p.offs[slot], p.n, k1, k2, p.pool_size, slot, at, hit);
#pragma unroll
      for (int sub = 0; sub < kPack; ++sub) {
        in_s[sub] = in_s[sub] + (hit[sub] ? s_in[at[sub]] * 0.5f : 0.0f);
        in_w[sub] = in_w[sub] + (hit[sub] ? w_in[at[sub]] * 0.5f : 0.0f);
      }
    }
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int j = j0 + sub * kLanes, l = l0 + sub * kLanes;
      const bool pad = j >= p.n;
      const float s_t = s_in[j], w_t = w_in[j];
      const int tc = tc_in[l];
      float s_new, w_new;
      int t_new;
      const int cv = gossip::pushsum_absorb(
          s_t, w_t, [&] { return gossip::pool2::tc_term(tc); },
          [&] { return gossip::pool2::tc_conv(tc); }, pad, !pad, in_s[sub],
          in_w[sub], delta, term_rounds, s_new, w_new, t_new);
      s_out[j] = s_new;
      w_out[j] = w_new;
      tc_out[l] = gossip::pool2::tc_pack(t_new, cv != 0);
      c += cv;
    }
  }
  finish_round(block_sum(c), p);
}

__global__ void gossip_pool2_shard_round(const int* __restrict__ n_in,
                                         const int* __restrict__ a_in,
                                         int* n_out, int* a_out, DeviceRound p,
                                         int rumor_target, int suppress) {
  if (p.ctrl[0]) return;
  const uint32_t k1 = (uint32_t)p.key[0], k2 = (uint32_t)p.key[1];
  int c = 0;
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < p.n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = shard_column_origin(col, p.row0);
    const int l0 = local_column_origin(col);
    int inbox[kPack];
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) inbox[sub] = 0;
    for (int slot = 0; slot < p.pool_size; ++slot) {
      int at[kPack];
      bool hit[kPack];
      slot_reads(j0, p.offs[slot], p.n, k1, k2, p.pool_size, slot, at, hit);
#pragma unroll
      for (int sub = 0; sub < kPack; ++sub)
        inbox[sub] += (hit[sub] && a_in[at[sub]] != 0) ? 1 : 0;
    }
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int j = j0 + sub * kLanes, l = l0 + sub * kLanes;
      const bool pad = j >= p.n;
      const int count = n_in[l];
      int cnt, act;
      c += gossip::gossip_absorb(
          [&] { return !pad && count >= rumor_target; }, [&] { return count; },
          [&] { return a_in[j]; }, pad, inbox[sub], rumor_target, suppress, cnt,
          act);
      n_out[l] = cnt;
      a_out[j] = act;
    }
  }
  finish_round(block_sum(c), p);
}

DeviceRound make_round(const long long* key, const int* offs, int n, int row0,
                       int rows, int pool_size, int* u, int* acc, int* ctrl,
                       int target) {
  DeviceRound p;
  p.key = key;
  p.offs = offs;
  p.n = n;
  p.row0 = row0;
  p.n_cols = rows / kPack * kLanes;
  p.pool_size = pool_size;
  p.u = u;
  p.acc = acc;
  p.ctrl = ctrl;
  p.target = target;
  return p;
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Each round entry point queues one launch on `stream` of CUDA device
// `device` and returns its launch error (a cudaError_t), 0 if none. The
// summary planes (push-sum s and w, gossip active) are the device's global
// [R, 128] copies, in and out; the other planes (push-sum's packed
// term|conv, gossip's count) are the device's [rows, 128] rows, global rows
// [row0, row0 + rows). key is the round's int64[2] key and offs its
// int32[pool_size] displacements, both on the device. acc is int32[2],
// zeroed once; ctrl the run's int32[2] (done, rounds) on this device. u is
// int32[1], or null for the verdict in the launch against `target`.

extern "C" int gossip_pushsum_pool2_shard_round(
    const float* s_in, const float* w_in, const int* tc_in, float* s_out,
    float* w_out, int* tc_out, const long long* key, const int* offs, int n,
    int row0, int rows, int pool_size, float delta, int term_rounds, int* u,
    int* acc, int* ctrl, int target, int device, void* stream_ptr) {
  static int grid_cache[64];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DeviceRound p = make_round(key, offs, n, row0, rows, pool_size, u, acc,
                                   ctrl, target);
  const int grid = round_grid(pushsum_pool2_shard_round, p.n_cols, device, grid_cache);
  pushsum_pool2_shard_round<<<grid, kBlock, 0, (cudaStream_t)stream_ptr>>>(
      s_in, w_in, tc_in, s_out, w_out, tc_out, p, delta, term_rounds);
  return (int)cudaGetLastError();
}

extern "C" int gossip_gossip_pool2_shard_round(
    const int* n_in, const int* a_in, int* n_out, int* a_out,
    const long long* key, const int* offs, int n, int row0, int rows,
    int pool_size, int rumor_target, int suppress, int* u, int* acc, int* ctrl,
    int target, int device, void* stream_ptr) {
  static int grid_cache[64];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DeviceRound p = make_round(key, offs, n, row0, rows, pool_size, u, acc,
                                   ctrl, target);
  const int grid = round_grid(gossip_pool2_shard_round, p.n_cols, device, grid_cache);
  gossip_pool2_shard_round<<<grid, kBlock, 0, (cudaStream_t)stream_ptr>>>(
      n_in, a_in, n_out, a_out, p, rumor_target, suppress);
  return (int)cudaGetLastError();
}

extern "C" int gossip_pool2_shard_verdict(const int* u, int shards, int target,
                                          int* ctrl, int device,
                                          void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // A super-step is one round; u holds one count per slot (a device of the
  // replicated-pool2 composition, a shard of the imp composition).
  gossip::shard_verdict<<<1, 1, 0, (cudaStream_t)stream_ptr>>>(
      u, 1, shards, 0, 1, target, ctrl);
  return (int)cudaGetLastError();
}
