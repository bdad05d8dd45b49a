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
//
// Failure model (the JAX kernels' use_gate, crashed and global_term,
// ops/fused_pool2.py:414-436, :478-565, :815-850; gossip :1010 on): a
// template flag F picks each round kernel's faulted instance, so the
// fault-free one keeps its code. The JAX kernels mask each source window's
// choices with the sources' regenerated gate words and streamed death
// window, P + 1 gate hashes and death reads a node a round. Here each node's
// send decision for a round is made once, by the thread that owns it, in
// the pass before (the init launch for the chunk's first round): one bit a
// node (csrc/faults.cuh send_flag: real, alive, gate open and, in gossip,
// active), packed 8 to a byte as the choice words are (csrc/pool2.cuh), in
// two planes by round parity, n_pad / 8 bytes each. A source's read tests
// its bit (csrc/pool2.cuh column_sources_sending: 2 bytes per slot per
// column), so a round hashes one gate word and reads one death word a node,
// moves 0.75 bytes a node of bits at P = 2, and gossip no longer reads its
// sources' active plane at all. The launch boundary orders the two
// parities. A push-sum node sends iff its own bit is set, so a blocked node
// keeps its whole mass; a dead node's packed tc (push-sum) or count and
// active (gossip, through its empty inbox) stay while its s and w absorb;
// the verdict counts conv among the live nodes against the round's quorum
// need (ops/faults.quorum_needs), seeded by the init launch from round
// start - 1's. Under global termination tc stays, the verdict counts the
// real nodes whose ratio moved more than delta * max(|s/w|, 1) and ends
// the run at 0, and the finish launch latches conv on every real node.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "pool2.cuh"
#include "threefry.cuh"

namespace {

using gossip::Faults;
using gossip::block_sum;
using gossip::finish_count;
using gossip::finish_verdict;
using gossip::grid_for;
using gossip::kBlock;
using gossip::round_gate_key;
using gossip::send_flag;
using gossip::pool2::column_sources;
using gossip::pool2::column_sources_sending;
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

// A faulted round's send bits and verdict inputs (unused by the fault-free
// instance): the bits of this round (cur) and of the next (next: null when
// no round follows, or in the init launch; then key is unused), the next
// round's key (its gate key is derived from it), the round's index in the
// chunk and its quorum need on the device (null without a crash model).
struct Sends {
  const uint8_t* cur;
  uint8_t* next;
  const long long* key;
  int r;
  const int* need;
};

// The gate key of the round that `s.next` is for, under F with a gate.
template <bool F>
__device__ __forceinline__ void next_gate_key(const Faults& f, const Sends& s,
                                              uint32_t& g1, uint32_t& g2) {
  g1 = g2 = 0u;
  if (F && s.next != nullptr)
    round_gate_key<F>(f, (uint32_t)s.key[0], (uint32_t)s.key[1], g1, g2);
}

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

// F: the failure model (see the header). F = false is the fault-free
// kernel, with none of its loads or tests.
template <bool F>
__global__ void pushsum_pool2_round(PushSumPool2 cur, PushSumPool2 nxt,
                                    const long long* __restrict__ key,
                                    const int* __restrict__ offs, int n,
                                    int n_cols, int pool_size, float delta,
                                    int term_rounds, int target, int* total,
                                    unsigned* ticket, int* ctrl, Faults f,
                                    Sends sd) {
  if (ctrl[0]) return;
  const uint32_t k1 = (uint32_t)key[0], k2 = (uint32_t)key[1];
  const bool global = F && f.global;
  uint32_t g1, g2;
  next_gate_key<F>(f, sd, g1, g2);
  int c = 0;
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = local_column_origin(col);
    float in_s[kPack], in_w[kPack];
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) in_s[sub] = in_w[sub] = 0.0f;
    for (int slot = 0; slot < pool_size; ++slot) {
      int src[kPack], ch[kPack];
      if constexpr (F)
        column_sources_sending(j0, offs[slot], n, k1, k2, pool_size, sd.cur,
                               src, ch);
      else
        column_sources(j0, offs[slot], n, k1, k2, pool_size, src, ch);
#pragma unroll
      for (int sub = 0; sub < kPack; ++sub) {
        const bool hit = ch[sub] == slot && j0 + sub * kLanes < n;
        if constexpr (F) {
          // Each half and each add flushed, as the plain round does.
          in_s[sub] = gossip::flush(
              in_s[sub] + (hit ? gossip::flush(cur.s[src[sub]] * 0.5f) : 0.0f));
          in_w[sub] = gossip::flush(
              in_w[sub] + (hit ? gossip::flush(cur.w[src[sub]] * 0.5f) : 0.0f));
        } else {
          in_s[sub] = in_s[sub] + (hit ? cur.s[src[sub]] * 0.5f : 0.0f);
          in_w[sub] = in_w[sub] + (hit ? cur.w[src[sub]] * 0.5f : 0.0f);
        }
      }
    }
    if constexpr (!F) {
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
    } else {
      // A node sends iff its own bit is set; a dead node's tc stays, and
      // only live nodes count.
      const uint32_t own = sd.cur[col];
      uint32_t bits = 0u;
#pragma unroll
      for (int sub = 0; sub < kPack; ++sub) {
        const int j = j0 + sub * kLanes;
        const bool pad = j >= n;
        const bool alive =
            f.death == nullptr || gossip::alive_in(f.death[j], f.start + sd.r);
        const float s_t = cur.s[j], w_t = cur.w[j];
        const int tc = cur.tc[j];
        float s_new, w_new;
        int t_new;
        int cv = gossip::pushsum_absorb<true, true>(
            s_t, w_t, [&] { return gossip::pool2::tc_term(tc); },
            [&] { return gossip::pool2::tc_conv(tc); }, pad, ((own >> sub) & 1u) != 0,
            in_s[sub], in_w[sub], delta, term_rounds, s_new, w_new, t_new);
        nxt.s[j] = s_new;
        nxt.w[j] = w_new;
        if (global) {
          cv = !pad && gossip::unstable_global(s_t, w_t, s_new, w_new, delta);
          nxt.tc[j] = tc;
        } else {
          nxt.tc[j] = gossip::pool2::tc_frozen(alive, tc, t_new, cv != 0);
        }
        c += alive ? cv : 0;
        bits |= (uint32_t)send_flag(f, true, j, n, sd.r + 1, g1, g2) << sub;
      }
      if (sd.next != nullptr) sd.next[col] = (uint8_t)bits;
    }
  }
  if constexpr (!F)
    finish_count(block_sum(c), total, ticket, ctrl, target, true);
  else
    finish_verdict(block_sum(c), total, ticket, ctrl, target, sd.need, global);
}

// Under F with global termination, a chunk whose rounds ended in the
// global verdict (done with a round executed; a chunk done at its init
// launch runs none) latches conv on every real node (j < n).
template <bool F>
__global__ void pushsum_pool2_finish(PushSumPool2 a, PushSumPool2 b, float* s,
                                     float* w, int* term, int* conv, int n,
                                     int n_pad, int global,
                                     const int* __restrict__ ctrl) {
  const PushSumPool2 x = (ctrl[1] & 1) ? b : a;
  const bool latch = F && global && ctrl[0] && ctrl[1] > 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const int tc = x.tc[j];
    s[j] = x.s[j];
    w[j] = x.w[j];
    term[j] = gossip::pool2::tc_term(tc);
    conv[j] = (gossip::pool2::tc_conv(tc) || (latch && j < n)) ? 1 : 0;
  }
}

// The faulted init launch: pushsum_pool2_init over packed-word columns,
// which also writes the chunk's first round's send bits (sd.next; null
// when the chunk runs no round) and seeds the verdict from the converged
// live count at round start - 1 under a crash model.
__global__ void pushsum_pool2_init_faulted(
    const float* __restrict__ s0, const float* __restrict__ w0,
    const int* __restrict__ t0, const int* __restrict__ c0, PushSumPool2 a,
    int n, int n_cols, Faults f, Sends sd, int* total, unsigned* ticket,
    int* ctrl, int target) {
  uint32_t g1, g2;
  next_gate_key<true>(f, sd, g1, g2);
  int c = 0;
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = local_column_origin(col);
    uint32_t bits = 0u;
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int j = j0 + sub * kLanes;
      const bool cv = c0[j] != 0;
      a.s[j] = s0[j];
      a.w[j] = w0[j];
      a.tc[j] = gossip::pool2::tc_pack(t0[j], cv);
      if (f.death == nullptr || gossip::alive_in(f.death[j], f.start - 1))
        c += cv ? 1 : 0;
      bits |= (uint32_t)send_flag(f, true, j, n, 0, g1, g2) << sub;
    }
    if (sd.next != nullptr) sd.next[col] = (uint8_t)bits;
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, false);
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

// F: the failure model, as in pushsum_pool2_round: a source delivers iff
// its send bit (active, alive, gate open) is set, so the sources' active
// plane is not read; a dead node's inbox counts nothing (its count and
// active stay), and the verdict is the quorum need among the live nodes.
template <bool F>
__global__ void gossip_pool2_round(GossipPool2 cur, GossipPool2 nxt,
                                   const long long* __restrict__ key,
                                   const int* __restrict__ offs, int n,
                                   int n_cols, int pool_size, int rumor_target,
                                   int suppress, int target, int* total,
                                   unsigned* ticket, int* ctrl, Faults f,
                                   Sends sd) {
  if (ctrl[0]) return;
  const uint32_t k1 = (uint32_t)key[0], k2 = (uint32_t)key[1];
  uint32_t g1, g2;
  next_gate_key<F>(f, sd, g1, g2);
  int c = 0;
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = local_column_origin(col);
    int inbox[kPack];
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) inbox[sub] = 0;
    for (int slot = 0; slot < pool_size; ++slot) {
      int src[kPack], ch[kPack];
      if constexpr (F) {
        column_sources_sending(j0, offs[slot], n, k1, k2, pool_size, sd.cur,
                               src, ch);
#pragma unroll
        for (int sub = 0; sub < kPack; ++sub)
          inbox[sub] += (ch[sub] == slot && j0 + sub * kLanes < n) ? 1 : 0;
      } else {
        column_sources(j0, offs[slot], n, k1, k2, pool_size, src, ch);
#pragma unroll
        for (int sub = 0; sub < kPack; ++sub) {
          const bool hit = ch[sub] == slot && j0 + sub * kLanes < n;
          inbox[sub] += (hit && cur.active[src[sub]] != 0) ? 1 : 0;
        }
      }
    }
    uint32_t bits = 0u;
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int j = j0 + sub * kLanes;
      const bool pad = j >= n;
      const bool alive = !F || f.death == nullptr ||
                         gossip::alive_in(f.death[j], f.start + sd.r);
      const int count = cur.count[j];
      int cnt, act;
      const int cv = gossip::gossip_absorb(
          [&] { return !pad && count >= rumor_target; }, [&] { return count; },
          [&] { return cur.active[j]; }, pad, alive ? inbox[sub] : 0,
          rumor_target, suppress, cnt, act);
      nxt.count[j] = cnt;
      nxt.active[j] = act;
      c += alive ? cv : 0;
      if constexpr (F)
        bits |= (uint32_t)send_flag(f, act != 0, j, n, sd.r + 1, g1, g2) << sub;
    }
    if constexpr (F)
      if (sd.next != nullptr) sd.next[col] = (uint8_t)bits;
  }
  if constexpr (!F)
    finish_count(block_sum(c), total, ticket, ctrl, target, true);
  else
    finish_verdict(block_sum(c), total, ticket, ctrl, target, sd.need, false);
}

// The faulted init launch of gossip (pushsum_pool2_init_faulted's form):
// the first round's bits from the input's active plane.
__global__ void gossip_pool2_init_faulted(const int* __restrict__ n0,
                                          const int* __restrict__ a0,
                                          GossipPool2 a, int n, int n_cols,
                                          int rumor_target, Faults f, Sends sd,
                                          int* total, unsigned* ticket,
                                          int* ctrl, int target) {
  uint32_t g1, g2;
  next_gate_key<true>(f, sd, g1, g2);
  int c = 0;
  for (int col = blockIdx.x * kBlock + threadIdx.x; col < n_cols;
       col += gridDim.x * kBlock) {
    const int j0 = local_column_origin(col);
    uint32_t bits = 0u;
#pragma unroll
    for (int sub = 0; sub < kPack; ++sub) {
      const int j = j0 + sub * kLanes;
      a.count[j] = n0[j];
      a.active[j] = a0[j];
      if (f.death == nullptr || gossip::alive_in(f.death[j], f.start - 1))
        c += (j < n && n0[j] >= rumor_target) ? 1 : 0;
      bits |= (uint32_t)send_flag(f, a0[j] != 0, j, n, 0, g1, g2) << sub;
    }
    if (sd.next != nullptr) sd.next[col] = (uint8_t)bits;
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, false);
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

// Queues a push-sum chunk: init, one launch a round, finish.
template <bool F>
cudaError_t queue_pushsum(const float* s0, const float* w0, const int* t0,
                          const int* c0, float* s, float* w, int* term,
                          int* conv, PushSumPool2 a, PushSumPool2 b,
                          const long long* keys, const int* offs, int* ctrl,
                          int* scratch, int n, int n_pad, int pool_size,
                          int rounds, float delta, int term_rounds, int target,
                          Faults f, uint8_t* sends, const int* needs,
                          int need_init, int device, cudaStream_t stream) {
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  const int n_cols = n_pad / kPack;
  if constexpr (!F) {
    pushsum_pool2_init<<<grid_for(pushsum_pool2_init, n_pad, device), kBlock, 0,
                         stream>>>(s0, w0, t0, c0, a, n_pad, totals + rounds,
                                   tickets + rounds, ctrl, target);
  } else {
    const Sends first{nullptr, rounds > 0 ? sends : nullptr, keys, 0, nullptr};
    pushsum_pool2_init_faulted<<<grid_for(pushsum_pool2_init_faulted, n_cols,
                                          device),
                                 kBlock, 0, stream>>>(
        s0, w0, t0, c0, a, n, n_cols, f, first, totals + rounds,
        tickets + rounds, ctrl, f.death ? need_init : target);
  }
  cudaError_t err = cudaGetLastError();
  const int grid = grid_for(pushsum_pool2_round<F>, n_cols, device);
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    const bool more = F && r + 1 < rounds;
    const Sends sd{F ? sends + (r & 1) * n_cols : nullptr,
                   more ? sends + ((r + 1) & 1) * n_cols : nullptr,
                   more ? keys + 2 * (r + 1) : nullptr, r,
                   F && needs ? needs + r : nullptr};
    pushsum_pool2_round<F><<<grid, kBlock, 0, stream>>>(
        r & 1 ? b : a, r & 1 ? a : b, keys + 2 * r, offs + r * pool_size, n,
        n_cols, pool_size, delta, term_rounds, target, totals + r, tickets + r,
        ctrl, f, sd);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  pushsum_pool2_finish<F><<<grid_for(pushsum_pool2_finish<F>, n_pad, device),
                            kBlock, 0, stream>>>(a, b, s, w, term, conv, n,
                                                 n_pad, f.global, ctrl);
  return cudaGetLastError();
}

template <bool F>
cudaError_t queue_gossip(const int* n0, const int* a0, int* count, int* active,
                         int* conv, GossipPool2 a, GossipPool2 b,
                         const long long* keys, const int* offs, int* ctrl,
                         int* scratch, int n, int n_pad, int pool_size,
                         int rounds, int rumor_target, int suppress, int target,
                         Faults f, uint8_t* sends, const int* needs,
                         int need_init, int device, cudaStream_t stream) {
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  const int n_cols = n_pad / kPack;
  if constexpr (!F) {
    gossip_pool2_init<<<grid_for(gossip_pool2_init, n_pad, device), kBlock, 0,
                        stream>>>(n0, a0, a, n, n_pad, rumor_target,
                                  totals + rounds, tickets + rounds, ctrl,
                                  target);
  } else {
    const Sends first{nullptr, rounds > 0 ? sends : nullptr, keys, 0, nullptr};
    gossip_pool2_init_faulted<<<grid_for(gossip_pool2_init_faulted, n_cols,
                                         device),
                                kBlock, 0, stream>>>(
        n0, a0, a, n, n_cols, rumor_target, f, first, totals + rounds,
        tickets + rounds, ctrl, f.death ? need_init : target);
  }
  cudaError_t err = cudaGetLastError();
  const int grid = grid_for(gossip_pool2_round<F>, n_cols, device);
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    const bool more = F && r + 1 < rounds;
    const Sends sd{F ? sends + (r & 1) * n_cols : nullptr,
                   more ? sends + ((r + 1) & 1) * n_cols : nullptr,
                   more ? keys + 2 * (r + 1) : nullptr, r,
                   F && needs ? needs + r : nullptr};
    gossip_pool2_round<F><<<grid, kBlock, 0, stream>>>(
        r & 1 ? b : a, r & 1 ? a : b, keys + 2 * r, offs + r * pool_size, n,
        n_cols, pool_size, rumor_target, suppress, target, totals + r,
        tickets + r, ctrl, f, sd);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  gossip_pool2_finish<<<grid_for(gossip_pool2_finish, n_pad, device), kBlock, 0,
                        stream>>>(a, b, count, active, conv, n, n_pad,
                                  rumor_target, ctrl);
  return cudaGetLastError();
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
// by the init launch. `faulted` picks the kernels' faulted instances, with
// the gate threshold (0: none), the death plane int32[n_pad] and the
// rounds' quorum needs int32[rounds] on the device (null: no crash model),
// the seed need of round start - 1, the chunk's first absolute round,
// (push-sum) global termination, and the send bits' two parities, uint8[2 *
// n_pad / 8] (unread by the fault-free instances).

extern "C" int gossip_pushsum_pool2_chunk(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* sA, float* wA, int* tcA, float* sB,
    float* wB, int* tcB, const long long* keys, const int* offs, int* ctrl,
    int* scratch, int n, int n_pad, int pool_size, int rounds, float delta,
    int term_rounds, int target, int faulted, unsigned thresh,
    const int* death, const int* needs, int need_init, int start, int global,
    uint8_t* sends, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const PushSumPool2 a{sA, wA, tcA}, b{sB, wB, tcB};
  const Faults f{thresh, death, needs, start, global};
  return (int)(faulted
                   ? queue_pushsum<true>(s0, w0, t0, c0, s, w, term, conv, a, b,
                                         keys, offs, ctrl, scratch, n, n_pad,
                                         pool_size, rounds, delta, term_rounds,
                                         target, f, sends, needs, need_init,
                                         device, stream)
                   : queue_pushsum<false>(s0, w0, t0, c0, s, w, term, conv, a, b,
                                          keys, offs, ctrl, scratch, n, n_pad,
                                          pool_size, rounds, delta, term_rounds,
                                          target, f, sends, needs, need_init,
                                          device, stream));
}

extern "C" int gossip_gossip_pool2_chunk(
    const int* n0, const int* a0, int* count, int* active, int* conv,
    int* nA, int* aA, int* nB, int* aB, const long long* keys, const int* offs,
    int* ctrl, int* scratch, int n, int n_pad, int pool_size, int rounds,
    int rumor_target, int suppress, int target, int faulted, unsigned thresh,
    const int* death, const int* needs, int need_init, int start,
    uint8_t* sends, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const GossipPool2 a{nA, aA}, b{nB, aB};
  const Faults f{thresh, death, needs, start, 0};
  return (int)(faulted
                   ? queue_gossip<true>(n0, a0, count, active, conv, a, b, keys,
                                        offs, ctrl, scratch, n, n_pad, pool_size,
                                        rounds, rumor_target, suppress, target,
                                        f, sends, needs, need_init, device,
                                        stream)
                   : queue_gossip<false>(n0, a0, count, active, conv, a, b, keys,
                                         offs, ctrl, scratch, n, n_pad,
                                         pool_size, rounds, rumor_target,
                                         suppress, target, f, sends, needs,
                                         need_init, device, stream));
}
