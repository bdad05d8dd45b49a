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
//
// Failure model (the JAX kernels' use_gate, crashed and global_term,
// parallel/pool2_sharded.py:303-306, :351-356, :469-488, :632-828): a
// template flag F picks each round kernel's faulted instance, so the
// fault-free one keeps its code. The composition is bitwise the streaming
// pool tier, and it takes that tier's design (csrc/fused_pool2.cu): each
// node's send decision for a round is made once, by the thread that owns
// it, in the round before (a sends launch for a run's first round): one
// bit a node (csrc/faults.cuh's rule: real, alive, gate open and, in
// gossip, active), packed 8 to a byte as the choice words are
// (csrc/pool2.cuh send_bit), in a global plane per round parity beside the
// device's summary copy. A device writes its own rows' bytes, and the wire
// carries them to the other devices with the summary rows: 1 bit a node
// beside push-sum's 64 bits of (s, w). A source's read tests its bit
// (column_sources_sending), so no device reads another's death plane or
// regenerates its gate words, and faulted gossip reads no source's active
// flag. Each device holds only its own rows of the death plane. A push-sum
// node sends iff its own bit is set, so a blocked node keeps its whole
// mass; a dead node's tc (push-sum) or count and active (gossip, through
// its empty inbox) stay while its s and w absorb; u counts conv among the
// live nodes, and the verdict compares the shards' sum with the round's
// quorum need (a table on the device, ops/faults.quorum_needs). Under
// global termination tc stays, u counts the real nodes whose ratio moved
// more than delta * max(|s/w|, 1), and the verdict fires at 0; the run
// then latches conv on every real node of its result.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "pool2.cuh"
#include "threefry.cuh"

namespace {

using gossip::block_sum;
using gossip::gate_key;
using gossip::gate_open;
using gossip::kBlock;
using gossip::round_grid;
using gossip::pool2::column_sources_sending;
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

// A faulted round's operands (unused by the fault-free instances): the
// gate threshold (0: none), the device's rows of the death plane (local
// index; null: no crash model) and the round's quorum need on the device
// (null: no crash model), the round's absolute index, push-sum's global
// termination, the round's send bits (the device's global plane) and the
// next round's (null: none is written), whose gate key is derived from
// the next round's key `next_key`.
struct ShardFaults {
  uint32_t thresh;
  const int* death;
  const int* need;
  int round, global;
  const uint8_t* sends;
  uint8_t* next;
  const long long* next_key;
};

// Whether node j (local index l) sends in round `round` under `f`: real,
// active (gossip; push-sum passes true), alive then and its gate word
// (key (g1, g2)) open: csrc/faults.cuh send_flag over the device's rows.
__device__ __forceinline__ bool shard_send(const ShardFaults& f, bool active,
                                           int j, int l, int n, int round,
                                           uint32_t g1, uint32_t g2) {
  const bool alive = f.death == nullptr || gossip::alive_in(f.death[l], round);
  return active & (j < n) & alive & gate_open(g1, g2, f.thresh, j);
}

// The gate key of the next round, when its bits are written and the run
// has a gate; (0, 0) otherwise (unused then).
__device__ __forceinline__ void next_gate(const ShardFaults& f, uint32_t& g1,
                                          uint32_t& g2) {
  g1 = g2 = 0u;
  if (f.next != nullptr && f.thresh != 0u)
    gate_key((uint32_t)f.next_key[0], (uint32_t)f.next_key[1], g1, g2);
}

// The launch's converged count: adds the block's count to acc[0]; the
// grid's last block resets acc and writes the total to *u or, without u,
// counts the round and sets the done flag from it: against the target, or
// under F the round's quorum need (f.need, where not null) or, under
// global termination, the unstable count's zero. Every other block read
// ctrl before it took its ticket, so the write races with no reader.
template <bool F>
__device__ inline void finish_round(int block_count, const DeviceRound& p,
                                    const ShardFaults& f) {
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
      if constexpr (!F)
        p.ctrl[0] = total >= p.target ? 1 : 0;
      else
        p.ctrl[0] = (f.global ? total == 0
                              : total >= (f.need ? *f.need : p.target))
                        ? 1
                        : 0;
    }
  }
}

// F: the failure model (see the header). F = false is the fault-free
// kernel, with none of its loads or tests.
template <bool F>
__global__ void pushsum_pool2_shard_round(const float* __restrict__ s_in,
                                          const float* __restrict__ w_in,
                                          const int* __restrict__ tc_in,
                                          float* s_out, float* w_out,
                                          int* tc_out, DeviceRound p,
                                          float delta, int term_rounds,
                                          ShardFaults f) {
  if (p.ctrl[0]) return;
  const uint32_t k1 = (uint32_t)p.key[0], k2 = (uint32_t)p.key[1];
  uint32_t g1 = 0u, g2 = 0u;
  if constexpr (F) next_gate(f, g1, g2);
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
      if constexpr (!F) {
        slot_reads(j0, p.offs[slot], p.n, k1, k2, p.pool_size, slot, at, hit);
      } else {
        int ch[kPack];
        column_sources_sending(j0, p.offs[slot], p.n, k1, k2, p.pool_size,
                               f.sends, at, ch);
#pragma unroll
        for (int sub = 0; sub < kPack; ++sub)
          hit[sub] = ch[sub] == slot && j0 + sub * kLanes < p.n;
      }
#pragma unroll
      for (int sub = 0; sub < kPack; ++sub) {
        if constexpr (F) {
          // Each half and each add flushed, as the plain round does.
          in_s[sub] = gossip::flush(
              in_s[sub] + (hit[sub] ? gossip::flush(s_in[at[sub]] * 0.5f) : 0.0f));
          in_w[sub] = gossip::flush(
              in_w[sub] + (hit[sub] ? gossip::flush(w_in[at[sub]] * 0.5f) : 0.0f));
        } else {
          in_s[sub] = in_s[sub] + (hit[sub] ? s_in[at[sub]] * 0.5f : 0.0f);
          in_w[sub] = in_w[sub] + (hit[sub] ? w_in[at[sub]] * 0.5f : 0.0f);
        }
      }
    }
    if constexpr (!F) {
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
    } else {
      // A node sends iff its own bit is set; a dead node's tc stays, and
      // only live nodes count. The column's byte of the bit planes is
      // row0 * 16 + col (csrc/pool2.cuh choice_word_index of j0).
      const int byte = p.row0 * (kLanes / kPack) + col;
      const uint32_t own = f.sends[byte];
      uint32_t bits = 0u;
#pragma unroll
      for (int sub = 0; sub < kPack; ++sub) {
        const int j = j0 + sub * kLanes, l = l0 + sub * kLanes;
        const bool pad = j >= p.n;
        const bool alive =
            f.death == nullptr || gossip::alive_in(f.death[l], f.round);
        const float s_t = s_in[j], w_t = w_in[j];
        const int tc = tc_in[l];
        float s_new, w_new;
        int t_new;
        int cv = gossip::pushsum_absorb<true, true>(
            s_t, w_t, [&] { return gossip::pool2::tc_term(tc); },
            [&] { return gossip::pool2::tc_conv(tc); }, pad,
            ((own >> sub) & 1u) != 0, in_s[sub], in_w[sub], delta,
            term_rounds, s_new, w_new, t_new);
        s_out[j] = s_new;
        w_out[j] = w_new;
        if (f.global) {
          cv = !pad && gossip::unstable_global(s_t, w_t, s_new, w_new, delta);
          tc_out[l] = tc;
        } else {
          tc_out[l] = gossip::pool2::tc_frozen(alive, tc, t_new, cv != 0);
        }
        c += alive ? cv : 0;
        bits |= (uint32_t)shard_send(f, true, j, l, p.n, f.round + 1, g1, g2)
                << sub;
      }
      if (f.next != nullptr) f.next[byte] = (uint8_t)bits;
    }
  }
  finish_round<F>(block_sum(c), p, f);
}

template <bool F>
__global__ void gossip_pool2_shard_round(const int* __restrict__ n_in,
                                         const int* __restrict__ a_in,
                                         int* n_out, int* a_out, DeviceRound p,
                                         int rumor_target, int suppress,
                                         ShardFaults f) {
  if (p.ctrl[0]) return;
  const uint32_t k1 = (uint32_t)p.key[0], k2 = (uint32_t)p.key[1];
  uint32_t g1 = 0u, g2 = 0u;
  if constexpr (F) next_gate(f, g1, g2);
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
      if constexpr (!F) {
        bool hit[kPack];
        slot_reads(j0, p.offs[slot], p.n, k1, k2, p.pool_size, slot, at, hit);
#pragma unroll
        for (int sub = 0; sub < kPack; ++sub)
          inbox[sub] += (hit[sub] && a_in[at[sub]] != 0) ? 1 : 0;
      } else {
        // A source delivers iff its send bit (active, alive, gate open) is
        // set: the sources' active flags are not read.
        int ch[kPack];
        column_sources_sending(j0, p.offs[slot], p.n, k1, k2, p.pool_size,
                               f.sends, at, ch);
#pragma unroll
        for (int sub = 0; sub < kPack; ++sub)
          inbox[sub] += (ch[sub] == slot && j0 + sub * kLanes < p.n) ? 1 : 0;
      }
    }
    uint32_t bits = 0u;
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int j = j0 + sub * kLanes, l = l0 + sub * kLanes;
      const bool pad = j >= p.n;
      const bool alive = !F || f.death == nullptr ||
                         gossip::alive_in(f.death[l], f.round);
      const int count = n_in[l];
      int cnt, act;
      const int cv = gossip::gossip_absorb(
          [&] { return !pad && count >= rumor_target; }, [&] { return count; },
          [&] { return a_in[j]; }, pad, alive ? inbox[sub] : 0, rumor_target,
          suppress, cnt, act);
      n_out[l] = cnt;
      a_out[j] = act;
      c += alive ? cv : 0;
      if constexpr (F)
        bits |= (uint32_t)shard_send(f, act != 0, j, l, p.n, f.round + 1, g1, g2)
                << sub;
    }
    if constexpr (F)
      if (f.next != nullptr) f.next[p.row0 * (kLanes / kPack) + col] = (uint8_t)bits;
  }
  finish_round<F>(block_sum(c), p, f);
}

// The send bits of a run's first round over the device's rows: from the
// active flags of the device's global plane (gossip; null for push-sum),
// its rows of the death plane and the round's gate key, into its bytes of
// the global bit plane `sends`.
__global__ void pool2_shard_sends(const int* __restrict__ active,
                                  ShardFaults f, uint32_t g1, uint32_t g2,
                                  int n, int row0, int n_cols, uint8_t* sends) {
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = shard_column_origin(col, row0);
    const int l0 = local_column_origin(col);
    uint32_t bits = 0u;
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int j = j0 + sub * kLanes;
      const bool act = active == nullptr || active[j] != 0;
      bits |= (uint32_t)shard_send(f, act, j, l0 + sub * kLanes, n, f.round,
                                   g1, g2)
              << sub;
    }
    sends[row0 * (kLanes / kPack) + col] = (uint8_t)bits;
  }
}

// The verdict of a round over per-slot counts, one thread: unless the run
// is done, count the round in ctrl[1] and set done once the slots' counts
// u[s] sum to the target, to the round's quorum need (*need, where need is
// not null) or, under global termination, to 0.
__global__ void pool2_shard_verdict(const int* u, int shards, int target,
                                    const int* need, int global, int* ctrl) {
  if (ctrl[0]) return;
  long long total = 0;
  for (int s = 0; s < shards; ++s) total += u[s];
  ctrl[1] += 1;
  ctrl[0] = (global ? total == 0 : total >= (need ? *need : target)) ? 1 : 0;
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

int pushsum_grid_cache[2][64];
int gossip_grid_cache[2][64];

template <bool F>
cudaError_t launch_pushsum(const float* s_in, const float* w_in,
                           const int* tc_in, float* s_out, float* w_out,
                           int* tc_out, const DeviceRound& p, float delta,
                           int term_rounds, const ShardFaults& f, int device,
                           cudaStream_t stream) {
  const int grid = round_grid(pushsum_pool2_shard_round<F>, p.n_cols, device,
                              pushsum_grid_cache[F ? 1 : 0]);
  pushsum_pool2_shard_round<F><<<grid, kBlock, 0, stream>>>(
      s_in, w_in, tc_in, s_out, w_out, tc_out, p, delta, term_rounds, f);
  return cudaGetLastError();
}

template <bool F>
cudaError_t launch_gossip(const int* n_in, const int* a_in, int* n_out,
                          int* a_out, const DeviceRound& p, int rumor_target,
                          int suppress, const ShardFaults& f, int device,
                          cudaStream_t stream) {
  const int grid = round_grid(gossip_pool2_shard_round<F>, p.n_cols, device,
                              gossip_grid_cache[F ? 1 : 0]);
  gossip_pool2_shard_round<F><<<grid, kBlock, 0, stream>>>(
      n_in, a_in, n_out, a_out, p, rumor_target, suppress, f);
  return cudaGetLastError();
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
// `faulted` picks the faulted instance, with the gate threshold (0: none),
// the device's rows of the death plane int32[rows * 128] and the round's
// quorum need int32[1] on the device (null: no crash model), the round's
// absolute index, (push-sum) global termination, and the device's global
// send-bit planes uint8[R * 16] of this round (read) and of the next
// (null: none written; its bytes of the device's rows are written), whose
// gate key is derived from the next round's key next_key (int64[2] on the
// device).

extern "C" int gossip_pushsum_pool2_shard_round(
    const float* s_in, const float* w_in, const int* tc_in, float* s_out,
    float* w_out, int* tc_out, const long long* key, const int* offs, int n,
    int row0, int rows, int pool_size, float delta, int term_rounds, int* u,
    int* acc, int* ctrl, int target, int faulted, unsigned thresh,
    const int* death, const int* need, int round, int global,
    const uint8_t* sends, uint8_t* next_sends, const long long* next_key,
    int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DeviceRound p = make_round(key, offs, n, row0, rows, pool_size, u, acc,
                                   ctrl, target);
  const ShardFaults f{thresh, death, need, round, global,
                      sends, next_sends, next_key};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return (int)(faulted ? launch_pushsum<true>(s_in, w_in, tc_in, s_out, w_out,
                                              tc_out, p, delta, term_rounds, f,
                                              device, stream)
                       : launch_pushsum<false>(s_in, w_in, tc_in, s_out, w_out,
                                               tc_out, p, delta, term_rounds, f,
                                               device, stream));
}

extern "C" int gossip_gossip_pool2_shard_round(
    const int* n_in, const int* a_in, int* n_out, int* a_out,
    const long long* key, const int* offs, int n, int row0, int rows,
    int pool_size, int rumor_target, int suppress, int* u, int* acc, int* ctrl,
    int target, int faulted, unsigned thresh, const int* death,
    const int* need, int round, const uint8_t* sends, uint8_t* next_sends,
    const long long* next_key, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DeviceRound p = make_round(key, offs, n, row0, rows, pool_size, u, acc,
                                   ctrl, target);
  const ShardFaults f{thresh, death, need, round, 0,
                      sends, next_sends, next_key};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return (int)(faulted ? launch_gossip<true>(n_in, a_in, n_out, a_out, p,
                                             rumor_target, suppress, f, device,
                                             stream)
                       : launch_gossip<false>(n_in, a_in, n_out, a_out, p,
                                              rumor_target, suppress, f, device,
                                              stream));
}

// The send bits of round `round` (key (k1, k2)) for the device's rows
// [row0, row0 + rows) into the global bit plane `sends`: from `active`
// (the device's global gossip active plane; null for push-sum), the gate
// threshold and the device's rows of the death plane (null: no crash
// model). One launch.
extern "C" int gossip_pool2_shard_sends(const int* active, const int* death,
                                        unsigned k1, unsigned k2,
                                        unsigned thresh, int round, int n,
                                        int row0, int rows, uint8_t* sends,
                                        int device, void* stream_ptr) {
  static int grid_cache[64];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  uint32_t g1 = 0u, g2 = 0u;
  if (thresh != 0u) gate_key(k1, k2, g1, g2);
  const ShardFaults f{thresh, death, nullptr, round, 0, nullptr, nullptr, nullptr};
  const int n_cols = rows / kPack * kLanes;
  const int grid = round_grid(pool2_shard_sends, n_cols, device, grid_cache);
  pool2_shard_sends<<<grid, kBlock, 0, (cudaStream_t)stream_ptr>>>(
      active, f, g1, g2, n, row0, n_cols, sends);
  return (int)cudaGetLastError();
}

extern "C" int gossip_pool2_shard_verdict(const int* u, int shards, int target,
                                          const int* need, int global,
                                          int* ctrl, int device,
                                          void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // A super-step is one round; u holds one count per slot (a device of the
  // replicated-pool2 composition, a shard of the imp composition).
  pool2_shard_verdict<<<1, 1, 0, (cudaStream_t)stream_ptr>>>(
      u, shards, target, need, global, ctrl);
  return (int)cudaGetLastError();
}
