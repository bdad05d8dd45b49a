// Offset-pool push-sum and gossip chunks on the implicit full topology,
// for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's
// ops/fused_pool.py: make_pushsum_pool_chunk (pallas_call at :860) and
// make_gossip_pool_chunk (pallas_call at :1157). Each runs K synchronous
// rounds of the protocol on the padded [rows, 128] layout:
//
//   choice(i) = (threefry(k1, k2, (row(i) / 8) * 128 + lane(i))
//                >> 4 * (row(i) % 8)) & (P - 1)
//   inbox[j]  = sum over slots k, in order from 0.0, of send[i] * [choice(i) == k]
//               with i = j - d_k if j >= d_k else j - d_k + n   (a mod-n roll)
//
// then the absorb with the term/conv latch (push-sum) or the receipt
// count with receiver-side suppression (gossip), and a done flag that
// stops the chunk once the converged count reaches the target. Pad lanes
// (j >= n) never send and never receive.
//
// What bounds it on this card: the memory system's latency, not bytes or
// operations. A round reads each node's state and its P slot sources and
// writes the state back (43 bytes a node for push-sum at P = 2), from
// planes that mostly stay in the 50 MB L2 at n_pad = 2**20 (at 2**21 they
// do not), and ends at the grid barrier (~2.5 us at 1M); its arithmetic (a
// dozen float ops a node and a 20-round Threefry per 8 nodes) is well under
// a microsecond of the card's rate.
//
// Design: the form of csrc/fused_resident.cu. One persistent cooperative
// launch runs every round of the chunk, one pass and one grid barrier a
// round; an init launch (the input into A, the done flag seeded) and a
// finish launch (the result into A) bracket it, so a chunk is 3 launches
// whatever K is. The grid is every block the SMs hold at once, never more
// than the packed words need (512 blocks at 1M; the capacity is asked once
// a device and pool width); the launch goes through
// cudaLaunchCooperativeKernel, which refuses a grid whose blocks are not
// all resident. The planes other nodes read are double-buffered: push-sum's
// s and w in A and B, and every node's pool slot (its mark, -1 for no
// send) in two int8 planes, mark[0] and mark[1]. What only the node itself
// reads is updated in place: push-sum's term and conv in A, gossip's count
// in A and its active and conv flags in one int8 plane, which the finish
// unpacks into A.
//   prologue - round 0's marks into mark[0] (gossip only from active
//              nodes), in the walk the rounds use; then one barrier;
//   round r  - a thread takes the 8 nodes of one packed choice word (one
//              lane, 8 rows 128 apart: csrc/pool.cuh word_node; neighbouring
//              threads on neighbouring lanes, so each warp reads 32
//              consecutive nodes a step) and hashes the word once for them.
//              In steps of nodes (kPushSumStep, kGossipStep) it first loads
//              each node's own state and gathers, over the slots in
//              ascending order, the halved s and w (push-sum) or the
//              receipts (gossip) of the slot source whose mark in
//              mark[r & 1] is the slot, from the round's current planes;
//              then absorbs each node and writes its round r + 1 mark into
//              mark[(r + 1) & 1] (in gossip from the active flag it has just
//              computed, held in a register); then the round's barrier
//              (csrc/persistent.cuh), whose 64-bit word carries the arrivals
//              and the converged count, so every block stops at the target
//              or the cap together. Block 0 writes the done flag and the
//              executed count to `ctrl` once, at the end.
// The pool width P is a template argument (2, 4, 8 or 16), so a receiver's
// slot loads are straight-line code issued together.
// scripts/pool_round_variants.py times the other forms: a thread a node
// hashing its own word, other steps, the width at run time, the own state
// through the absorb's accessors (PERF.md §6).
// Ordering: pass r + 1 writes mark[r & 1] and the plane set that pass r
// read, and every block has passed barrier r before it starts pass r + 1;
// the mark[(r + 1) & 1] that pass r writes was last read by pass r - 1,
// before barrier r - 1. Marks written for a round that never runs are
// never read. A chunk from a converged state: the init launch sets the done
// flag, and every block of the persistent launch reads it at entry and
// leaves. No send plane is written: the halve happens on the gather.
//
// Failure model (the JAX kernels' use_gate, crashed and global_term,
// ops/fused_pool.py:519-536, :897-903): a template flag F picks each round
// kernel's faulted instance, so the fault-free one keeps its code. Under F
// a node's mark for round r + 1 is -1 when its drop-gate word (a Threefry
// word a node off the round's gate key, its round key folded with the gate
// tag as ops/fused.gate_round_keys folds it, hashed at the node's flat
// index: the partitionable stream is position-wise) is below
// the threshold or the node is dead then; it is folded in where round r's
// pass writes that mark, so the mark planes' parity is unchanged. A
// push-sum node sends iff its own mark is set, so a blocked node keeps its
// whole mass. A dead node's term and conv (gossip: its receipts) stay while
// its s and w absorb, and the barrier word counts conv among the live
// nodes against the round's quorum need (a table the host draws from the
// sorted death plane, ops/faults.quorum_needs); the init launch seeds the
// verdict from the need of round start - 1. Under global termination term
// and conv stay, the barrier word counts the real nodes whose ratio moved
// more than delta * max(|s/w|, 1), and the round where none did latches
// conv on every real node. Under a recovery model (the JAX kernels'
// revived and fresh_rejoin, ops/fused_pool.py:626-646, :975-980) a node is
// alive again from its revival round on; where it rejoins with a reset
// (gossip always, push-sum under rejoin="fresh") every reader of its
// round-start state in that round takes the reset value: its own absorb
// (term and conv too, which it alone reads and writes in place, so the
// quorum count never sees a half-reset node), and its receivers through the
// mark its owner writes a round ahead: -1 for gossip (a rejoined node is
// inactive), with csrc/faults.cuh's kRejoinBit for push-sum (the receivers
// take half of (j, 0)). The stored planes stay un-reset until the round
// runs, so a chunk that ends just before it hands back the state a resume
// expects. The init launch seeds the verdict from the live nodes of round
// start - 1, revivals counted. Under a Byzantine model (the JAX kernels'
// byzantine plane, ops/fused_pool.py) a push-sum adversary's owner sets
// kLieBit on its mark a round ahead where it sends, and each receiver
// applies the mode to what it reads of that source (csrc/faults.cuh
// read_send: the whole (s, w), the negated halves, or the halves swapped);
// the owner keeps its honest halve. A live gossip adversary's state takes
// the mode's override at the end of its absorb (stale_rumor: count 0,
// active, unconverged; garble: conv), before its conv enters the barrier
// word and its next mark is written; a dead node's conv stays. The faulted
// push-sum instance flushes as the plain round does (csrc/chunk.cuh).
//
// Telemetry (the JAX kernels' counter block, ops/fused_pool.py:544-567,
// :738-790): a template flag T, with F, picks each round kernel's telemetry
// instance. Its threads add up the row's counts and sums over their nodes
// from the state each node's absorb has just written (after the global
// latch's verdict: the reduce counts every real node converged in the round
// that ended the chunk), each block writes its partials of the round before
// the round's barrier, and a fourth launch after finish sums them into the
// rows (csrc/telemetry.cuh; the estimate error reads w = 0 as 1 and the
// mass is the padded plane's Σw less n_pad, as the JAX row does). The
// drop count regenerates the round's gate words, as the JAX row does.
//
// Numerics: built without fast math, with -fmad=false and denormals kept
// (utils/kernels.py), and the slot sums run from 0.0 in ascending slot
// order, so push-sum is bitwise the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "persistent.cuh"
#include "pool.cuh"
#include "telemetry.cuh"

namespace {

using gossip::Faults;
using gossip::GossipPlanes;
using gossip::PushSumPlanes;
using gossip::block_sum;
using gossip::cooperative_grid;
using gossip::kBlock;
using gossip::kChoicePack;
using gossip::pool_mark;
using gossip::pool_word;
using gossip::round_barrier;
using gossip::round_gate_key;
using gossip::word_node;
using gossip::zero_control;

// A chunk's arguments, passed to its persistent kernel by value.
struct PushSumChunk {
  PushSumPlanes a;  // the result; term and conv are updated in place
  float* s_b;       // the other half of s and w's ping/pong pair
  float* w_b;
  int8_t* mark;  // int8[2 * n_pad]: the marks of each round parity
  const long long* keys;
  const int* offs;
  int n, n_pad, rounds;
  float delta;
  int term_rounds, target;
  unsigned long long* words;  // the barrier words: rounds, then the prologue's
  int* ctrl;
  Faults f;
  int* tele;    // [rounds, grid, kPartials]: the telemetry partials (T)
  float tmean;  // push-sum's true mean (T)
};

struct GossipChunk {
  GossipPlanes a;  // the result; count is updated in place
  int8_t* flags;   // each node's active and conv flags, updated in place
  int8_t* mark;
  const long long* keys;
  const int* offs;
  int n, n_pad, rounds, rumor_target, suppress, target;
  unsigned long long* words;
  int* ctrl;
  Faults f;
  int* tele;  // (T)
};

// Nodes of a thread's walk whose loads (own state and slot gathers) are
// issued together before their absorbs and stores: the stores of one node
// would otherwise hold back the next node's loads, one L2 round trip a node.
// Gossip's loads are a few registers a node; push-sum's are many, and its
// larger steps cost more in registers and occupancy than they saved
// (scripts/pool_round_variants.py, PERF.md).
constexpr int kPushSumStep = 1;
constexpr int kGossipStep = 4;

// A gossip node's flags byte: its active flag and its conv flag.
constexpr int kActive = 1;
constexpr int kConv = 2;

// Round 0's marks into mark[0], a thread a packed word as in the rounds;
// `flags` is gossip's flags plane (only active nodes send) or null
// (push-sum: every real node sends); under F the gate and the dead mark -1.
template <int P, bool F>
__device__ __forceinline__ void prologue_marks(int8_t* mark,
                                               const int8_t* flags,
                                               const long long* keys, Faults f,
                                               int n, int n_pad) {
  const uint32_t k0 = (uint32_t)keys[0], k1 = (uint32_t)keys[1];
  uint32_t g1, g2;
  round_gate_key<F>(f, k0, k1, g1, g2);
  for (int wi = blockIdx.x * kBlock + threadIdx.x; wi < n_pad / kChoicePack;
       wi += gridDim.x * kBlock) {
    const uint32_t word = pool_word(k0, k1, word_node(wi, 0));
    for (int sub = 0; sub < kChoicePack; ++sub) {
      const int j = word_node(wi, sub);
      if constexpr (F)
        mark[j] = gossip::lie_mark(
            gossip::rejoin_mark(pool_mark(word, j, n, P),
                                flags == nullptr || (flags[j] & kActive),
                                flags != nullptr, f, 0, g1, g2, j),
            flags == nullptr ? f.byz : nullptr, j, f.start);
      else
        mark[j] = flags == nullptr || (flags[j] & kActive) ? pool_mark(word, j, n, P)
                                                           : (int8_t)-1;
    }
  }
}

// ---------------------------------------------------------------- push-sum

// F: the failure model. A node's mark for round r + 1 is -1 when the gate
// blocks it or it is dead then, and a node sends in a round iff its own
// mark is set, so a blocked node keeps its whole mass. A dead node's term
// and conv stay as they were while its s and w absorb, and the verdict is
// the round's quorum need among the live nodes. Under global termination
// term and conv are left alone, the barrier word counts the real nodes
// whose ratio moved more than the global rule allows, and the round where
// none did latches conv on every real node. F = false is the fault-free
// kernel, with none of these loads or tests. T (with F): the telemetry
// rows' partials of each round (see the header).
template <int P, bool F, bool T = false>
__global__ void pushsum_rounds(PushSumChunk c) {
  static_assert(F || !T, "the telemetry instance is a faulted instance");
  // The init launch's verdict: every block reads the same value.
  if (c.ctrl[0] || c.rounds == 0) return;
  prologue_marks<P, F>(c.mark, nullptr, c.keys, c.f, c.n, c.n_pad);
  round_barrier(c.words + c.rounds, 0);
  const PushSumPlanes a = c.a;
  const bool global = F && c.f.global;
  int executed = 0;
  bool done = false;
  while (!done && executed < c.rounds) {
    const int r = executed;
    const float* cur_s = (r & 1) ? c.s_b : a.s;
    const float* cur_w = (r & 1) ? c.w_b : a.w;
    float* nxt_s = (r & 1) ? a.s : c.s_b;
    float* nxt_w = (r & 1) ? a.w : c.w_b;
    const int8_t* mk = c.mark + (r & 1) * c.n_pad;
    const int* od = c.offs + r * P;
    int8_t* next =
        r + 1 < c.rounds ? c.mark + ((r + 1) & 1) * c.n_pad : nullptr;
    const uint32_t k0 = next ? (uint32_t)c.keys[2 * r + 2] : 0u;
    const uint32_t k1 = next ? (uint32_t)c.keys[2 * r + 3] : 0u;
    uint32_t g1, g2;
    round_gate_key<F>(c.f, k0, k1, g1, g2);
    uint32_t rg1 = 0u, rg2 = 0u;  // this round's gate key (T)
    if constexpr (T)
      round_gate_key<F>(c.f, (uint32_t)c.keys[2 * r], (uint32_t)c.keys[2 * r + 1],
                        rg1, rg2);
    gossip::tele::Acc acc;  // the round's sums over the thread's nodes (T)
    int count = 0;
    for (int wi = blockIdx.x * kBlock + threadIdx.x; wi < c.n_pad / kChoicePack;
         wi += gridDim.x * kBlock) {
      // The packed word of the thread's 8 nodes, hashed once for them.
      const uint32_t word = next ? pool_word(k0, k1, word_node(wi, 0)) : 0u;
#pragma unroll 1
      for (int sub0 = 0; sub0 < kChoicePack; sub0 += kPushSumStep) {
        // The step's loads first: each node's own state and its slot
        // gathers, in flight together.
        float s_t[kPushSumStep], w_t[kPushSumStep];
        float in_s[kPushSumStep], in_w[kPushSumStep];
        int t_old[kPushSumStep], c_old[kPushSumStep];
#pragma unroll
        for (int h = 0; h < kPushSumStep; ++h) {
          const int j = word_node(wi, sub0 + h);
          s_t[h] = cur_s[j];
          w_t[h] = cur_w[j];
          t_old[h] = a.term[j];
          c_old[h] = a.conv[j];
          in_s[h] = 0.0f;
          in_w[h] = 0.0f;
          if (j < c.n) {
            if constexpr (F)
              gossip::pool_pushsum_inbox_rejoin<P>(od, mk, cur_s, cur_w, j,
                                                   c.n, in_s[h], in_w[h],
                                                   c.f.byz_mode);
            else
              gossip::pool_pushsum_inbox<P>(od, mk, cur_s, cur_w, j, c.n,
                                            in_s[h], in_w[h]);
          }
        }
#pragma unroll
        for (int h = 0; h < kPushSumStep; ++h) {
          const int j = word_node(wi, sub0 + h);
          const bool pad = j >= c.n;
          float s_new, w_new;
          int t_new;
          if constexpr (!F) {
            // Every real node sends; pad lanes keep their mass.
            const int cv = gossip::pushsum_absorb(
                s_t[h], w_t[h], [&] { return t_old[h]; },
                [&] { return c_old[h] != 0; }, pad, !pad, in_s[h], in_w[h],
                c.delta, c.term_rounds, s_new, w_new, t_new);
            nxt_s[j] = s_new;
            nxt_w[j] = w_new;
            a.term[j] = t_new;
            a.conv[j] = cv;
            if (next) next[j] = pool_mark(word, j, c.n, P);
            count += cv;
          } else {
            // A node sends iff its mark is set; a dead node's term and conv
            // stay, and only live nodes count. A fresh rejoin starts the
            // round at (j, 0, initial term, 0).
            const bool alive =
                gossip::node_alive(c.f.death, c.f.revive, j, c.f.start + r);
            gossip::rejoin_pushsum(
                gossip::rejoins(c.f.revive, c.f.reset, j, c.f.start + r), j,
                c.f.init_term, s_t[h], w_t[h], t_old[h], c_old[h]);
            int cv = gossip::pushsum_absorb<true, true>(
                s_t[h], w_t[h], [&] { return t_old[h]; },
                [&] { return c_old[h] != 0; }, pad, mk[j] >= 0, in_s[h],
                in_w[h], c.delta, c.term_rounds, s_new, w_new, t_new);
            nxt_s[j] = s_new;
            nxt_w[j] = w_new;
            if (global) {
              cv = !pad && gossip::unstable_global(s_t[h], w_t[h], s_new, w_new,
                                                   c.delta);
            } else {
              t_new = gossip::frozen(alive, t_new, t_old[h]);
              cv = gossip::frozen(alive, cv, c_old[h]);
              a.term[j] = t_new;
              a.conv[j] = cv;
            }
            if (next)
              next[j] = gossip::lie_mark(
                  gossip::rejoin_mark(pool_mark(word, j, c.n, P), true, false,
                                      c.f, r + 1, g1, g2, j),
                  c.f.byz, j, c.f.start + r + 1);
            count += alive ? cv : 0;
            if constexpr (T) {
              // The row of the node's new state: under global termination
              // its conv stays until the latch.
              namespace tl = gossip::tele;  // this file has a kConv and kActive of its own
              const int round = c.f.start + r;
              const int conv_now = global ? c_old[h] : cv;
              acc.i[tl::kConv] += conv_now;
              acc.i[tl::kLive] += alive;
              acc.i[tl::kConvAlive] += alive ? conv_now : 0;
              acc.i[tl::kDrops] += c.f.thresh != 0u && !pad && alive &&
                               !gossip::gate_open(rg1, rg2, c.f.thresh, j);
              acc.i[tl::kRevived] += c.f.revive != nullptr && c.f.revive[j] == round;
              acc.i[tl::kByz] += gossip::byzantine_in(c.f.byz, j, round);
              if (conv_now) acc.add(tl::kErr, tl::pool_err(s_new, w_new, c.tmean));
              acc.add(tl::kW, w_new);
              if (global)
                acc.add(tl::kErrAll, pad ? 0.0f : tl::pool_err(s_new, w_new, c.tmean));
            }
          }
        }
      }
    }
    if constexpr (T)
      gossip::tele::block_partials<kBlock>(
          acc, c.tele + ((size_t)r * gridDim.x + blockIdx.x) *
                            gossip::tele::kPartials);
    if constexpr (!F) {
      done = round_barrier(c.words + r, block_sum(count)) >= c.target;
    } else {
      const int total = round_barrier(c.words + r, block_sum(count));
      // Global: the round's unstable count; crash: the round's quorum need.
      done = global ? total == 0
                    : total >= (c.f.death ? c.f.needs[r] : c.target);
    }
    ++executed;
  }
  // Global termination: the round whose verdict ended the run latches conv
  // on every real node.
  if (global && done)
    for (int j = blockIdx.x * kBlock + threadIdx.x; j < c.n_pad;
         j += gridDim.x * kBlock)
      a.conv[j] = j < c.n ? 1 : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    c.ctrl[0] = done ? 1 : 0;
    c.ctrl[1] = executed;
  }
}

// The result into A: B's s and w when the executed count is odd (term and
// conv stay in A throughout).
__global__ void pushsum_finish(PushSumChunk c) {
  if (!(c.ctrl[1] & 1)) return;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < c.n_pad;
       j += gridDim.x * kBlock) {
    c.a.s[j] = c.s_b[j];
    c.a.w[j] = c.w_b[j];
  }
}

// ------------------------------------------------------------------ gossip

// The input into A, the flags packed from the input's active and conv
// planes, and the done flag seeded from the input's converged count; under
// a crash model (`death` not null), from its converged live count at
// `seed_round` (the round before the chunk) against `target` (that
// round's quorum need).
__global__ void gossip_init(GossipChunk c, const int* __restrict__ n0,
                            const int* __restrict__ a0,
                            const int* __restrict__ c0, const int* death,
                            const int* revive, int seed_round, int target,
                            int* total, unsigned* ticket) {
  int converged = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < c.n_pad;
       j += gridDim.x * kBlock) {
    c.a.count[j] = n0[j];
    c.a.active[j] = a0[j];
    c.a.conv[j] = c0[j];
    c.flags[j] =
        (int8_t)((a0[j] != 0 ? kActive : 0) | (c0[j] != 0 ? kConv : 0));
    if (gossip::node_alive(death, revive, j, seed_round)) converged += c0[j];
  }
  gossip::finish_count(block_sum(converged), total, ticket, c.ctrl, target,
                       false);
}

// Only a node itself reads its count, active and conv flags (other nodes
// read its marks), so they are updated in place: count in A, the two flags
// in one byte, 5 bytes a node each way a round where three int32 ping/pong
// planes moved 12.
// F: the failure model, as in pushsum_rounds: blocked and dead nodes mark
// -1, a dead node's inbox counts nothing (its count and active flag stay),
// and the verdict is the quorum need among the live nodes. T (with F): the
// telemetry rows' partials of each round.
template <int P, bool F, bool T = false>
__global__ void gossip_rounds(GossipChunk c) {
  static_assert(F || !T, "the telemetry instance is a faulted instance");
  if (c.ctrl[0] || c.rounds == 0) return;
  prologue_marks<P, F>(c.mark, c.flags, c.keys, c.f, c.n, c.n_pad);
  round_barrier(c.words + c.rounds, 0);
  int executed = 0;
  bool done = false;
  while (!done && executed < c.rounds) {
    const int r = executed;
    const int8_t* mk = c.mark + (r & 1) * c.n_pad;
    const int* od = c.offs + r * P;
    int8_t* next =
        r + 1 < c.rounds ? c.mark + ((r + 1) & 1) * c.n_pad : nullptr;
    const uint32_t k0 = next ? (uint32_t)c.keys[2 * r + 2] : 0u;
    const uint32_t k1 = next ? (uint32_t)c.keys[2 * r + 3] : 0u;
    uint32_t g1, g2;
    round_gate_key<F>(c.f, k0, k1, g1, g2);
    uint32_t rg1 = 0u, rg2 = 0u;  // this round's gate key (T)
    if constexpr (T)
      round_gate_key<F>(c.f, (uint32_t)c.keys[2 * r], (uint32_t)c.keys[2 * r + 1],
                        rg1, rg2);
    gossip::tele::Acc acc;  // (T)
    int count = 0;
    for (int wi = blockIdx.x * kBlock + threadIdx.x; wi < c.n_pad / kChoicePack;
         wi += gridDim.x * kBlock) {
      // The packed word of the thread's 8 nodes, hashed once for them.
      const uint32_t word = next ? pool_word(k0, k1, word_node(wi, 0)) : 0u;
#pragma unroll 1
      for (int sub0 = 0; sub0 < kChoicePack; sub0 += kGossipStep) {
        int count0[kGossipStep], flags0[kGossipStep], inbox[kGossipStep];
#pragma unroll
        for (int h = 0; h < kGossipStep; ++h) {
          const int j = word_node(wi, sub0 + h);
          count0[h] = c.a.count[j];
          flags0[h] = c.flags[j];
          inbox[h] = j < c.n ? gossip::pool_gossip_inbox<P>(od, mk, j, c.n) : 0;
        }
#pragma unroll
        for (int h = 0; h < kGossipStep; ++h) {
          const int j = word_node(wi, sub0 + h);
          int cnt, act;
          if constexpr (!F) {
            const int cv = gossip::gossip_absorb(
                [&] { return (flags0[h] & kConv) != 0; },
                [&] { return count0[h]; }, [&] { return flags0[h] & kActive; },
                j >= c.n, inbox[h],
                c.rumor_target, c.suppress, cnt, act);
            c.a.count[j] = cnt;
            c.flags[j] = (int8_t)((act ? kActive : 0) | (cv ? kConv : 0));
            if (next)
              next[j] = act ? pool_mark(word, j, c.n, P) : (int8_t)-1;
            count += cv;
          } else {
            // A dead node's receipts are dropped; only live nodes count. A
            // node that rejoins this round starts it at (0, inactive, 0).
            const bool alive =
                gossip::node_alive(c.f.death, c.f.revive, j, c.f.start + r);
            if (gossip::rejoins(c.f.revive, c.f.reset, j, c.f.start + r)) {
              int act0, cv0;
              gossip::rejoin_gossip(true, count0[h], act0, cv0);
              flags0[h] = (act0 ? kActive : 0) | (cv0 ? kConv : 0);
            }
            int cv = gossip::gossip_absorb(
                [&] { return (flags0[h] & kConv) != 0; },
                [&] { return count0[h]; }, [&] { return flags0[h] & kActive; },
                j >= c.n, alive ? inbox[h] : 0,
                c.rumor_target, c.suppress, cnt, act);
            // A dead node's conv stays; a live adversary's state takes the
            // Byzantine mode's override.
            cv = gossip::frozen(alive, cv, (flags0[h] & kConv) ? 1 : 0);
            gossip::gossip_override(
                c.f.byz_mode,
                alive && gossip::byzantine_in(c.f.byz, j, c.f.start + r), cnt,
                act, cv);
            c.a.count[j] = cnt;
            c.flags[j] = (int8_t)((act ? kActive : 0) | (cv ? kConv : 0));
            if (next)
              next[j] = gossip::rejoin_mark(pool_mark(word, j, c.n, P), act, true, c.f,
                                  r + 1, g1, g2, j);
            count += alive ? cv : 0;
            if constexpr (T) {
              namespace tl = gossip::tele;  // this file has a kConv and kActive of its own
              const int round = c.f.start + r;
              acc.i[tl::kConv] += cv;
              acc.i[tl::kLive] += alive;
              acc.i[tl::kConvAlive] += alive ? cv : 0;
              acc.i[tl::kActive] += act;
              acc.i[tl::kDrops] += c.f.thresh != 0u && j < c.n && alive &&
                               !gossip::gate_open(rg1, rg2, c.f.thresh, j);
              acc.i[tl::kRevived] += c.f.revive != nullptr && c.f.revive[j] == round;
              acc.i[tl::kByz] += gossip::byzantine_in(c.f.byz, j, round);
            }
          }
        }
      }
    }
    if constexpr (T)
      gossip::tele::block_partials<kBlock>(
          acc, c.tele + ((size_t)r * gridDim.x + blockIdx.x) *
                            gossip::tele::kPartials);
    if constexpr (!F) {
      done = round_barrier(c.words + r, block_sum(count)) >= c.target;
    } else {
      const int total = round_barrier(c.words + r, block_sum(count));
      done = total >= (c.f.death ? c.f.needs[r] : c.target);
    }
    ++executed;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    c.ctrl[0] = done ? 1 : 0;
    c.ctrl[1] = executed;
  }
}

// The flags into A's active and conv planes when a round ran.
__global__ void gossip_finish(GossipChunk c) {
  if (c.ctrl[1] == 0) return;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < c.n_pad;
       j += gridDim.x * kBlock) {
    const int flags = c.flags[j];
    c.a.active[j] = flags & kActive;
    c.a.conv[j] = (flags & kConv) ? 1 : 0;
  }
}

// The persistent grid of each kernel instance (fault-free, faulted,
// telemetry), asked once a device: one cache a pool width (2, 4, 8, 16).
int pushsum_grid_cache[3][4][64];
int gossip_grid_cache[3][4][64];

constexpr int width_index(int pool_size) {
  return pool_size == 2 ? 0 : pool_size == 4 ? 1 : pool_size == 8 ? 2 : 3;
}

// The telemetry instance's reduce of a chunk's rows (`rows`, float32
// [rounds, 10]) from its partials, after finish.
cudaError_t queue_rows(const int* tele, const int* ctrl, float* rows, int grid,
                       int rounds, int n, int target, const Faults& f,
                       int n_pad, bool pushsum, cudaStream_t stream) {
  const gossip::tele::RowArgs a{tele, ctrl, rows, grid, rounds, n, target,
                                f.death ? f.needs : nullptr, n_pad,
                                pushsum ? 1 : 0, pushsum ? f.global : 0};
  return gossip::tele::queue_rows(a, stream);
}

// Queues a push-sum chunk at pool width P: init, the persistent launch,
// finish, all three on the persistent grid, and under T the reduce of the
// rows. A telemetry instance's grid must be the one its scratch was sized
// for (`want`, from gossip_pool_grid).
template <int P, bool F, bool T = false>
cudaError_t queue_pushsum(PushSumChunk c, const float* s0, const float* w0,
                          const int* t0, const int* c0, int need_init,
                          int device, cudaStream_t stream, float* rows = nullptr,
                          int want = 0) {
  int grid = 0;
  cudaError_t err = cooperative_grid(
      pushsum_rounds<P, F, T>, c.n_pad / kChoicePack, device,
      pushsum_grid_cache[T ? 2 : F ? 1 : 0][width_index(P)], &grid);
  if (err != cudaSuccess) return err;
  if (T && grid != want) return cudaErrorInvalidValue;
  int* init_words = (int*)(c.words + c.rounds + 1);
  if (F && c.f.death != nullptr)
    gossip::pushsum_init_live<<<grid, kBlock, 0, stream>>>(
        s0, w0, t0, c0, c.a, c.n_pad, c.f.death, c.f.revive, c.f.start - 1,
        init_words,
        (unsigned*)(init_words + 1), c.ctrl, need_init);
  else
    gossip::pushsum_init<<<grid, kBlock, 0, stream>>>(
        s0, w0, t0, c0, c.a, c.n_pad, init_words, (unsigned*)(init_words + 1),
        c.ctrl, c.target);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  void* args[] = {&c};
  err = cudaLaunchCooperativeKernel((const void*)pushsum_rounds<P, F, T>, grid,
                                    kBlock, args, 0, stream);
  if (err != cudaSuccess) return err;
  pushsum_finish<<<grid, kBlock, 0, stream>>>(c);
  err = cudaGetLastError();
  if (!T || err != cudaSuccess) return err;
  return queue_rows(c.tele, c.ctrl, rows, grid, c.rounds, c.n, c.target, c.f,
                    c.n_pad, true, stream);
}

template <int P, bool F, bool T = false>
cudaError_t queue_gossip(GossipChunk c, const int* n0, const int* a0,
                         const int* c0, int need_init, int device,
                         cudaStream_t stream, float* rows = nullptr,
                         int want = 0) {
  int grid = 0;
  cudaError_t err = cooperative_grid(
      gossip_rounds<P, F, T>, c.n_pad / kChoicePack, device,
      gossip_grid_cache[T ? 2 : F ? 1 : 0][width_index(P)], &grid);
  if (err != cudaSuccess) return err;
  if (T && grid != want) return cudaErrorInvalidValue;
  int* init_words = (int*)(c.words + c.rounds + 1);
  const bool crash = F && c.f.death != nullptr;
  gossip_init<<<grid, kBlock, 0, stream>>>(
      c, n0, a0, c0, crash ? c.f.death : nullptr, c.f.revive, c.f.start - 1,
      crash ? need_init : c.target, init_words, (unsigned*)(init_words + 1));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  void* args[] = {&c};
  err = cudaLaunchCooperativeKernel((const void*)gossip_rounds<P, F, T>, grid,
                                    kBlock, args, 0, stream);
  if (err != cudaSuccess) return err;
  gossip_finish<<<grid, kBlock, 0, stream>>>(c);
  err = cudaGetLastError();
  if (!T || err != cudaSuccess) return err;
  return queue_rows(c.tele, c.ctrl, rows, grid, c.rounds, c.n, c.target, c.f,
                    c.n_pad, false, stream);
}

// The instance of a queue function for pool width P, the failure model and
// telemetry (which runs with the faulted instance).
#define GOSSIP_POOL_CASE(W, fn, faulted, tele, ...)                       \
  case W:                                                                 \
    return (int)(tele      ? fn<W, true, true>(__VA_ARGS__)               \
                 : faulted ? fn<W, true, false>(__VA_ARGS__)              \
                           : fn<W, false, false>(__VA_ARGS__));
#define GOSSIP_POOL_DISPATCH(fn, faulted, tele, ...)                      \
  switch (pool_size) {                                                    \
    GOSSIP_POOL_CASE(2, fn, faulted, tele, __VA_ARGS__)                   \
    GOSSIP_POOL_CASE(4, fn, faulted, tele, __VA_ARGS__)                   \
    GOSSIP_POOL_CASE(8, fn, faulted, tele, __VA_ARGS__)                   \
    default: GOSSIP_POOL_CASE(16, fn, faulted, tele, __VA_ARGS__)         \
  }

bool valid_chunk(int n, int n_pad, int pool_size, int rounds) {
  return rounds >= 0 && n >= 2 && n <= n_pad &&
         n_pad % (gossip::kChoicePack * gossip::kChoiceLanes) == 0 &&
         (pool_size == 2 || pool_size == 4 || pool_size == 8 ||
          pool_size == 16);
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Both entry points zero the control words and queue three launches on
// `stream` of CUDA device `device` (the init launch, the persistent
// cooperative launch that runs every round, the finish launch, all three on
// the persistent grid, so no occupancy is asked after a device's first
// chunk at a pool width) and return the first error (a cudaError_t), 0 if
// none. Outputs and control words are allocated by the caller: the A planes
// receive the result, the B planes are the other half of the ping/pong pair
// (push-sum: s and w only); mark is int8[2 * n_pad]; keys int64[2 * rounds]
// (uint32 words) and offs int32[rounds * pool_size] are on the device;
// pool_size is 2, 4, 8 or 16; ctrl holds the chunk's control words:
// int32[2] (done, rounds executed), then 8 * (rounds + 2) bytes of scratch,
// the per-round barrier words (uint64, rounds of them, then the
// prologue's) and the init launch's total and ticket (int32 each); ctrl
// must be 8-byte aligned. byz is the int32 [n_pad] Byzantine onset plane
// (pad lanes never; null: no adversary) and byz_mode its mode
// (csrc/faults.cuh), both read by the faulted instance only. tele (int32
// [rounds, tele_grid, 10] of scratch; null: no telemetry) picks the
// telemetry instance, with faulted set and tele_grid the grid
// gossip_pool_grid gives it; its reduce writes the rows' [rounds, 10]
// float32 into rows, as a fourth launch; tmean is push-sum's true mean.

extern "C" int gossip_pushsum_pool_chunk(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* s_b, float* w_b, int8_t* mark,
    const long long* keys, const int* offs, int* ctrl, int n, int n_pad,
    int pool_size, int rounds, float delta, int term_rounds, int target,
    int faulted, unsigned thresh, const int* death, const int* needs,
    int need_init, int start, const int* revive, int reset, int init_term,
    int global, const int* byz, int byz_mode, int* tele, float* rows,
    int tele_grid, float tmean, int device, void* stream_ptr) {
  if (!valid_chunk(n, n_pad, pool_size, rounds) || (tele && !faulted))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // The control words, zeroed on the stream ahead of the chunk.
  err = zero_control(ctrl, rounds, stream);
  if (err != cudaSuccess) return (int)err;
  const PushSumChunk c{PushSumPlanes{s, w, term, conv},
                       s_b, w_b, mark, keys, offs, n, n_pad, rounds, delta,
                       term_rounds, target,
                       (unsigned long long*)(ctrl + 2), ctrl,
                       Faults{thresh, death, needs, start, global, revive,
                              reset, init_term, byz, byz_mode},
                       tele, tmean};
  GOSSIP_POOL_DISPATCH(queue_pushsum, faulted, tele != nullptr, c, s0, w0, t0,
                       c0, need_init, device, stream, rows, tele_grid)
}

extern "C" int gossip_gossip_pool_chunk(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int8_t* flags, int8_t* mark, const long long* keys,
    const int* offs, int* ctrl, int n, int n_pad,
    int pool_size, int rounds, int rumor_target, int suppress, int target,
    int faulted, unsigned thresh, const int* death, const int* needs,
    int need_init, int start, const int* revive, int reset, const int* byz,
    int byz_mode, int* tele, float* rows, int tele_grid, float tmean,
    int device, void* stream_ptr) {
  (void)tmean;  // gossip rows carry no estimate
  if (!valid_chunk(n, n_pad, pool_size, rounds) || (tele && !faulted))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // The control words, zeroed on the stream ahead of the chunk.
  err = zero_control(ctrl, rounds, stream);
  if (err != cudaSuccess) return (int)err;
  const GossipChunk c{GossipPlanes{count, active, conv}, flags, mark, keys,
                      offs, n, n_pad, rounds, rumor_target, suppress, target,
                      (unsigned long long*)(ctrl + 2), ctrl,
                      Faults{thresh, death, needs, start, 0, revive, reset, 0,
                             byz, byz_mode},
                      tele};
  GOSSIP_POOL_DISPATCH(queue_gossip, faulted, tele != nullptr, c, n0, a0, c0,
                       need_init, device, stream, rows, tele_grid)
}

// The grid of the telemetry instance's persistent launch (push-sum or
// gossip) at pool width pool_size on an n_pad layout: the blocks whose
// partials a chunk's scratch holds. Returns the grid, or minus a
// cudaError_t.
extern "C" int gossip_pool_grid(int pushsum, int pool_size, int n_pad,
                                int device) {
  if (!valid_chunk(2, n_pad, pool_size, 0)) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  int grid = 0;
  const int work = n_pad / kChoicePack, w = width_index(pool_size);
#define GOSSIP_POOL_GRID(W)                                                  \
  case W:                                                                    \
    err = pushsum ? cooperative_grid(pushsum_rounds<W, true, true>, work,     \
                                     device, pushsum_grid_cache[2][w], &grid) \
                  : cooperative_grid(gossip_rounds<W, true, true>, work,      \
                                     device, gossip_grid_cache[2][w], &grid); \
    break;
  switch (pool_size) {
    GOSSIP_POOL_GRID(2)
    GOSSIP_POOL_GRID(4)
    GOSSIP_POOL_GRID(8)
    default: GOSSIP_POOL_GRID(16)
  }
#undef GOSSIP_POOL_GRID
  return err == cudaSuccess ? grid : -(int)err;
}
