// Resident lattice push-sum and gossip chunks, for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of the JAX package's two resident
// lattice tiers: ops/fused.py make_pushsum_chunk (pallas_call at :741) and
// make_gossip_chunk (:993), the whole-array tier (n <= 131,072), and
// ops/fused_stencil.py make_pushsum_stencil2_chunk (:268) and
// make_gossip_stencil2_chunk (:427), the tiled tier (any alignment, state
// planes up to its 100 MB budget). Both tiers compute the function of
// csrc/fused_stencil.cu, K synchronous rounds on one of the six arithmetic
// lattices:
//
//   d(i)     = the slot-th live direction of sender i, slot =
//              threefry(k1, k2, i) % degree(i)        (csrc/stencil.cuh)
//   inbox[j] = sum over the sorted displacement classes c, from 0.0, of
//              send[i] * [d(i) == class c]  with i = j - d_c mod n
//
// then the absorb with the term/conv latch (push-sum) or the receipt count
// with receiver-side suppression (gossip), stopping once the converged
// count reaches the target. Pad lanes (j >= n) and degree-0 nodes never
// send; pad lanes never receive. The split of the two tiers is the TPU's
// VMEM budget; here one kernel pair serves both, and the ladder still
// names the JAX tier.
//
// What bounds it on this card: latency, not bytes or operations. The state
// is small: at the tiled tier's largest populations (2^20 padded nodes)
// push-sum's ping/pong planes, the two int8 mark planes and the directions
// word are 39 MB, so they stay in the 50 MB L2 from round to round. At 1M
// nodes a round is the gathers' L2 round trips (~28 of ~31 µs); at the
// small shapes (grid2d 10,000: 40 blocks; line 1000: 4) about half of it
// is the grid barrier (PERF.md §6).
//
// Design: one persistent cooperative launch runs every round of the chunk,
// one pass and one grid barrier a round. Its grid is every block the SMs
// hold at once, never more than the nodes need (the capacity is asked once
// a device): at torus3d 1M, 660 blocks of 256 threads (5 an SM at 45
// registers). Fewer blocks wait less at the barrier but cost the gathers
// more than they save: capped at 132, 264 and 528 blocks a 1M round took
// 124, 66 and 38 µs against 32 with all 660 (PERF.md §6, on the H100). All
// blocks are resident, so they may wait for each other; the launch goes
// through cudaLaunchCooperativeKernel, which refuses a grid that is not.
// The state is in ping/pong planes A and B, the marks in two int8 planes,
// mark[0] and mark[1]:
//   prologue - each sender writes its round-0 mark into mark[0]: the class
//              index of its draw, read through its static directions word
//              (csrc/shard.cuh word_mark; -1 for no send; gossip only from
//              active nodes); then one barrier;
//   round j  - each receiver gathers, per class in ascending order, the
//              send of its class source whose mark in mark[j & 1] is that
//              class, from the round's current planes, and writes the
//              absorbed state to the other planes; in the same pass it
//              writes its own round j + 1 mark into mark[(j + 1) & 1] (in
//              gossip from the active flag it has just computed, held in a
//              register); then the round's barrier.
// Ordering: pass j + 1 writes mark[j & 1] and the plane set that pass j
// read, and every block has passed barrier j before it starts pass j + 1;
// the mark[(j + 1) & 1] that pass j writes was last read by pass j - 1,
// before barrier j - 1. Marks that pass j writes for a round that never
// runs (the target was reached) are never read.
//
// The barrier is one 64-bit word a round in the chunk's scratch, carrying
// arrivals and the converged count, after which every block makes the same
// stop choice (csrc/persistent.cuh, shared with csrc/fused_pool.cu). The
// parity of the executed-round count lives in a register and names the
// current planes; block 0 writes it to `ctrl` once, at the end. The init
// and finish launches of csrc/chunk.cuh bracket the persistent launch as
// they do the streaming kernels, so a chunk is 3 launches whatever K is. A
// chunk from a converged state: the init launch sets the done flag, and
// every block of the persistent launch reads it at entry and leaves.
//
// Failure model (the JAX whole-array kernels' use_gate, crashed and
// global_term, ops/fused.py:426-436, :518-525, :559-575, :770-775,
// :835-860; the tiled tier takes global termination only, as the JAX one
// does): a template flag F picks each round kernel's faulted instance, so
// the fault-free one keeps its code. Under F a node's mark for round j + 1
// is -1 when its drop-gate word (a Threefry word at the node's flat index
// off the round's gate key, the round key folded with the gate tag, derived
// once a thread a round) is below the threshold or the node is dead then;
// it is folded in where pass j writes that mark (the prologue's for round
// 0), so the mark planes' parity and the one barrier a round are
// unchanged. A push-sum node sends iff its own mark is set, so a blocked
// node keeps its whole mass; a dead gossip node's inbox counts nothing. A
// dead node's term and conv (gossip: count, active, conv, through its empty
// inbox) stay while its s and w absorb, and the barrier word counts conv
// among the live nodes against the round's quorum need (a table the host
// draws from the sorted death plane, ops/faults.quorum_needs); the init
// launch seeds the verdict from the need of round start - 1. Under global
// termination term and conv stay, the barrier word counts the real nodes
// whose ratio moved more than delta * max(|s/w|, 1), and the round where
// none did latches conv on every real node (j < n: the pad lanes of both
// tiers' layouts stay out of the count and the latch). Under a recovery
// model (the JAX fused.py:499-509, :821-832) a node is alive again from its
// revival round on; where it rejoins with a reset (gossip always, push-sum
// under rejoin="fresh") every reader of its round-start state in that
// round takes the reset value: its own absorb, and its receivers through
// its mark, which the pass before (or the prologue) writes -1 for gossip
// (a rejoined node is inactive) and with csrc/faults.cuh's kRejoinBit for
// push-sum (the receivers take half of (j, 0)). The stored planes stay
// un-reset until the round runs, so a chunk that ends just before it hands
// back the state a resume expects. Under a Byzantine model (the JAX
// kernels' byzantine plane, ops/fused.py) a push-sum adversary's owner sets
// kLieBit on its mark a round ahead where it sends, beside kRejoinBit, and
// each receiver applies the mode to what it reads of that source
// (csrc/faults.cuh read_send, from the reset state where both bits are
// set); the owner keeps its honest halve. A live gossip adversary's state
// takes the mode's override after its absorb, before its conv is counted
// and its next mark written; a dead node's conv stays. The faulted push-sum
// instance flushes as the plain round does, with the stencil delivery's
// kept s half (csrc/chunk.cuh). The fault planes are
// read-only in the round loop, and a node's term and conv are written only
// by the thread that owns it, so no pass is split and no block leaves the
// loop alone.
//
// Telemetry (the JAX whole-array kernels' counter block, ops/fused.py:
// 447-490, :612-664): a template flag T, with F, picks each round kernel's
// telemetry instance, as in csrc/fused_pool.cu: each block writes its
// partial counts and sums of the round's new state before the round's
// barrier, and a fourth launch sums them into the rows (csrc/telemetry.cuh;
// the estimate error is s / w as the JAX stencil row takes it, and the mass
// the padded plane's Σw less n_pad). Only the whole-array tier (rows 5-6)
// runs it; the tiled tier (rows 7-8) demotes, as the JAX ladder demotes
// stencil2.
//
// Numerics: built without fast math, with -fmad=false and denormals kept;
// the halve happens before the class sums, and the sums run from 0.0 in
// ascending class order, as the chunked engine's halve_and_send and
// deliver_stencil do, so push-sum is bitwise the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "persistent.cuh"
#include "shard.cuh"
#include "stencil.cuh"
#include "telemetry.cuh"

namespace {

using gossip::Classes;
using gossip::Faults;
using gossip::GossipPlanes;
using gossip::PushSumPlanes;
using gossip::block_sum;
using gossip::cooperative_grid;
using gossip::kBlock;
using gossip::round_barrier;
using gossip::round_gate_key;
using gossip::word_mark;
using gossip::zero_control;

// Round 0's marks into mark[0]; `active` is the input's active plane
// (gossip) or null (push-sum: every node of degree > 0 sends); under F the
// gate and the dead mark -1.
template <bool F>
__device__ __forceinline__ void prologue_marks(int8_t* mark, const int* active,
                                               const int* __restrict__ dirs,
                                               const long long* keys,
                                               const Faults& f, int n_pad) {
  const uint32_t k0 = (uint32_t)keys[0], k1 = (uint32_t)keys[1];
  uint32_t g1, g2;
  round_gate_key<F>(f, k0, k1, g1, g2);
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool on = active == nullptr || active[j] != 0;
    mark[j] = F ? gossip::lie_mark(
                      gossip::rejoin_mark(word_mark(dirs[j], k0, k1, j), on,
                                          active != nullptr, f, 0, g1, g2, j),
                      active == nullptr ? f.byz : nullptr, j, f.start)
                : (on ? word_mark(dirs[j], k0, k1, j) : (int8_t)-1);
  }
}

// ---------------------------------------------------------------- push-sum

// F: the failure model (see the header). F = false is the fault-free
// kernel, with none of its loads or tests. T (with F): the telemetry rows'
// partials of each round, into tele ([rounds, grid, kPartials]).
template <bool F, bool T = false>
__global__ void pushsum_rounds(PushSumPlanes a, PushSumPlanes b, int8_t* mark,
                               const long long* keys,
                               const int* __restrict__ dirs, Classes cls,
                               int n, int n_pad, int rounds, float delta,
                               int term_rounds, int target,
                               unsigned long long* words, int* ctrl, Faults f,
                               int* tele, float tmean) {
  static_assert(F || !T, "the telemetry instance is a faulted instance");
  // The init launch's verdict: every block reads the same value.
  if (ctrl[0] || rounds == 0) return;
  prologue_marks<F>(mark, nullptr, dirs, keys, f, n_pad);
  round_barrier(words + rounds, 0);
  const bool global = F && f.global;
  int executed = 0;
  bool done = false;
  while (!done && executed < rounds) {
    const int r = executed;
    const PushSumPlanes cur = (r & 1) ? b : a;
    const PushSumPlanes nxt = (r & 1) ? a : b;
    const int8_t* mk = mark + (r & 1) * n_pad;
    int8_t* next = r + 1 < rounds ? mark + ((r + 1) & 1) * n_pad : nullptr;
    const uint32_t k0 = next ? (uint32_t)keys[2 * r + 2] : 0u;
    const uint32_t k1 = next ? (uint32_t)keys[2 * r + 3] : 0u;
    uint32_t g1, g2;
    round_gate_key<F>(f, k0, k1, g1, g2);
    uint32_t rg1 = 0u, rg2 = 0u;  // this round's gate key (T)
    if constexpr (T)
      round_gate_key<F>(f, (uint32_t)keys[2 * r], (uint32_t)keys[2 * r + 1],
                        rg1, rg2);
    gossip::tele::Acc acc;  // the round's sums over the thread's nodes (T)
    int c = 0;
    for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
         j += gridDim.x * kBlock) {
      const bool pad = j >= n;
      float in_s = 0.0f, in_w = 0.0f;
      if (!pad) {
        if constexpr (F)
          gossip::pushsum_inbox_rejoin(cls, mk, cur.s, cur.w, j, n, in_s, in_w,
                                       f.byz_mode);
        else
          gossip::pushsum_inbox(cls, mk, cur.s, cur.w, j, n, in_s, in_w);
      }
      if constexpr (!F) {
        // mk[j] < 0 on pad lanes and degree 0: those keep their mass.
        c += gossip::pushsum_absorb_node(cur, nxt, j, pad, mk[j] >= 0, in_s,
                                         in_w, delta, term_rounds);
        if (next) next[j] = word_mark(dirs[j], k0, k1, j);
      } else {
        // A node sends iff its mark is set (blocked and dead nodes keep
        // their mass); a dead node's term and conv stay, and only live
        // nodes count. A fresh rejoin starts the round at (j, 0, initial
        // term, 0).
        const bool alive = gossip::node_alive(f.death, f.revive, j, f.start + r);
        float s_t = cur.s[j], w_t = cur.w[j];
        int t_old = cur.term[j], c_old = cur.conv[j];
        gossip::rejoin_pushsum(gossip::rejoins(f.revive, f.reset, j, f.start + r),
                               j, f.init_term, s_t, w_t, t_old, c_old);
        float s_new, w_new;
        int t_new;
        int cv = gossip::pushsum_absorb<true, false>(
            s_t, w_t, [&] { return t_old; }, [&] { return c_old != 0; }, pad,
            mk[j] >= 0, in_s, in_w, delta, term_rounds, s_new, w_new, t_new);
        nxt.s[j] = s_new;
        nxt.w[j] = w_new;
        if (global) {
          cv = !pad && gossip::unstable_global(s_t, w_t, s_new, w_new, delta);
          nxt.term[j] = t_old;
          nxt.conv[j] = c_old;
        } else {
          nxt.term[j] = gossip::frozen(alive, t_new, t_old);
          cv = gossip::frozen(alive, cv, c_old);
          nxt.conv[j] = cv;
        }
        if (next)
          next[j] = gossip::lie_mark(
              gossip::rejoin_mark(word_mark(dirs[j], k0, k1, j), true, false,
                                  f, r + 1, g1, g2, j),
              f.byz, j, f.start + r + 1);
        c += alive ? cv : 0;
        if constexpr (T) {
          // The row of the node's new state: under global termination its
          // conv stays until the latch.
          using namespace gossip::tele;
          const int round = f.start + r;
          const int conv_now = global ? c_old : cv;
          acc.i[kConv] += conv_now;
          acc.i[kLive] += alive;
          acc.i[kConvAlive] += alive ? conv_now : 0;
          acc.i[kDrops] += f.thresh != 0u && !pad && alive &&
                           !gossip::gate_open(rg1, rg2, f.thresh, j);
          acc.i[kRevived] += f.revive != nullptr && f.revive[j] == round;
          acc.i[kByz] += gossip::byzantine_in(f.byz, j, round);
          if (conv_now) acc.add(kErr, stencil_err(s_new, w_new, tmean));
          acc.add(kW, w_new);
          if (global) acc.add(kErrAll, pad ? 0.0f : stencil_err(s_new, w_new, tmean));
        }
      }
    }
    if constexpr (T)
      gossip::tele::block_partials<kBlock>(
          acc, tele + ((size_t)r * gridDim.x + blockIdx.x) *
                          gossip::tele::kPartials);
    if constexpr (!F) {
      done = round_barrier(words + r, block_sum(c)) >= target;
    } else {
      const int total = round_barrier(words + r, block_sum(c));
      // Global: the round's unstable count; crash: the round's quorum need.
      done = global ? total == 0 : total >= (f.death ? f.needs[r] : target);
    }
    ++executed;
  }
  // Global termination: the round whose verdict ended the run latches conv
  // on every real node of the result's plane set.
  if (global && done) {
    int* conv = (executed & 1) ? b.conv : a.conv;
    for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
         j += gridDim.x * kBlock)
      conv[j] = j < n ? 1 : 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctrl[0] = done ? 1 : 0;
    ctrl[1] = executed;
  }
}

// ------------------------------------------------------------------ gossip

// F: the failure model, as in pushsum_rounds: blocked and dead nodes mark
// -1, a dead node's inbox counts nothing (its count, active and conv
// stay), and the verdict is the quorum need among the live nodes. T (with
// F): the telemetry rows' partials, as in pushsum_rounds.
template <bool F, bool T = false>
__global__ void gossip_rounds(GossipPlanes a, GossipPlanes b, int8_t* mark,
                              const long long* keys,
                              const int* __restrict__ dirs, Classes cls, int n,
                              int n_pad, int rounds, int rumor_target,
                              int suppress, int target,
                              unsigned long long* words, int* ctrl, Faults f,
                              int* tele) {
  static_assert(F || !T, "the telemetry instance is a faulted instance");
  if (ctrl[0] || rounds == 0) return;
  prologue_marks<F>(mark, a.active, dirs, keys, f, n_pad);
  round_barrier(words + rounds, 0);
  int executed = 0;
  bool done = false;
  while (!done && executed < rounds) {
    const int r = executed;
    const GossipPlanes cur = (r & 1) ? b : a;
    const GossipPlanes nxt = (r & 1) ? a : b;
    const int8_t* mk = mark + (r & 1) * n_pad;
    int8_t* next = r + 1 < rounds ? mark + ((r + 1) & 1) * n_pad : nullptr;
    const uint32_t k0 = next ? (uint32_t)keys[2 * r + 2] : 0u;
    const uint32_t k1 = next ? (uint32_t)keys[2 * r + 3] : 0u;
    uint32_t g1, g2;
    round_gate_key<F>(f, k0, k1, g1, g2);
    uint32_t rg1 = 0u, rg2 = 0u;  // this round's gate key (T)
    if constexpr (T)
      round_gate_key<F>(f, (uint32_t)keys[2 * r], (uint32_t)keys[2 * r + 1],
                        rg1, rg2);
    gossip::tele::Acc acc;  // (T)
    int c = 0;
    for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
         j += gridDim.x * kBlock) {
      const bool pad = j >= n;
      const bool alive =
          !F || gossip::node_alive(f.death, f.revive, j, f.start + r);
      // A node that rejoins this round starts it at (0, inactive, 0).
      const bool rn = F && gossip::rejoins(f.revive, f.reset, j, f.start + r);
      const int inbox = pad || !alive ? 0 : gossip::gossip_inbox(cls, mk, j, n);
      int cnt, act;
      int cv = gossip::gossip_absorb(
          [&] { return !rn && cur.conv[j] != 0; },
          [&] { return rn ? 0 : cur.count[j]; },
          [&] { return rn ? 0 : cur.active[j]; }, pad, inbox, rumor_target,
          suppress, cnt, act);
      if constexpr (F) {
        // A dead node's conv stays; a live adversary's state takes the
        // Byzantine mode's override.
        cv = gossip::frozen(alive, cv, cur.conv[j]);
        gossip::gossip_override(
            f.byz_mode, alive && gossip::byzantine_in(f.byz, j, f.start + r),
            cnt, act, cv);
      }
      nxt.count[j] = cnt;
      nxt.active[j] = act;
      nxt.conv[j] = cv;
      if (next) {
        if constexpr (F)
          next[j] = gossip::rejoin_mark(word_mark(dirs[j], k0, k1, j), act,
                                        true, f, r + 1, g1, g2, j);
        else
          next[j] = act ? word_mark(dirs[j], k0, k1, j) : (int8_t)-1;
      }
      c += alive ? cv : 0;
      if constexpr (T) {
        using namespace gossip::tele;
        const int round = f.start + r;
        acc.i[kConv] += cv;
        acc.i[kLive] += alive;
        acc.i[kConvAlive] += alive ? cv : 0;
        acc.i[kActive] += act;
        acc.i[kDrops] += f.thresh != 0u && !pad && alive &&
                         !gossip::gate_open(rg1, rg2, f.thresh, j);
        acc.i[kRevived] += f.revive != nullptr && f.revive[j] == round;
        acc.i[kByz] += gossip::byzantine_in(f.byz, j, round);
      }
    }
    if constexpr (T)
      gossip::tele::block_partials<kBlock>(
          acc, tele + ((size_t)r * gridDim.x + blockIdx.x) *
                          gossip::tele::kPartials);
    if constexpr (!F) {
      done = round_barrier(words + r, block_sum(c)) >= target;
    } else {
      const int total = round_barrier(words + r, block_sum(c));
      done = total >= (f.death ? f.needs[r] : target);
    }
    ++executed;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctrl[0] = done ? 1 : 0;
    ctrl[1] = executed;
  }
}

// The persistent grid of each kernel instance (fault-free, faulted,
// telemetry), asked once a device.
int pushsum_grid_cache[3][64];
int gossip_grid_cache[3][64];

// What a telemetry chunk's reduce needs beyond the chunk's own arguments.
struct Tele {
  int* part;    // [rounds, grid, kPartials]; null: no telemetry
  float* rows;  // [rounds, 10]
  int grid;     // the grid the scratch was sized for (gossip_resident_grid)
  float tmean;
};

// The reduce of a telemetry chunk's rows, after finish.
cudaError_t queue_rows(const Tele& t, const int* ctrl, int rounds, int n,
                       int target, const Faults& f, int n_pad, bool pushsum,
                       cudaStream_t stream) {
  const gossip::tele::RowArgs a{t.part, ctrl, t.rows, t.grid, rounds, n, target,
                                f.death ? f.needs : nullptr, n_pad,
                                pushsum ? 1 : 0, pushsum ? f.global : 0};
  return gossip::tele::queue_rows(a, stream);
}

// Queues a push-sum chunk: init (the crash model's live seed verdict under
// F with a death plane), the persistent launch, finish, all on its grid,
// and under T the reduce of the rows.
template <bool F, bool T = false>
cudaError_t queue_pushsum(PushSumPlanes a, PushSumPlanes b, int8_t* mark,
                          const long long* keys, const int* dirs, Classes cls,
                          int n, int n_pad, int rounds, float delta,
                          int term_rounds, int target, unsigned long long* words,
                          int* ctrl, Faults f, const float* s0, const float* w0,
                          const int* t0, const int* c0, int need_init,
                          int device, cudaStream_t stream, Tele t) {
  int grid = 0;
  cudaError_t err = cooperative_grid(pushsum_rounds<F, T>, n_pad, device,
                                     pushsum_grid_cache[T ? 2 : F ? 1 : 0], &grid);
  if (err != cudaSuccess) return err;
  if (T && grid != t.grid) return cudaErrorInvalidValue;
  int* init_words = (int*)(words + rounds + 1);
  if (F && f.death != nullptr)
    gossip::pushsum_init_live<<<grid, kBlock, 0, stream>>>(
        s0, w0, t0, c0, a, n_pad, f.death, f.revive, f.start - 1, init_words,
        (unsigned*)(init_words + 1), ctrl, need_init);
  else
    gossip::pushsum_init<<<grid, kBlock, 0, stream>>>(
        s0, w0, t0, c0, a, n_pad, init_words, (unsigned*)(init_words + 1),
        ctrl, target);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  void* args[] = {&a,      &b,     &mark,        &keys,   &dirs,
                  &cls,    &n,     &n_pad,       &rounds, &delta,
                  &term_rounds,    &target,      &words,  &ctrl, &f,
                  &t.part, &t.tmean};
  err = cudaLaunchCooperativeKernel((const void*)pushsum_rounds<F, T>, grid,
                                    kBlock, args, 0, stream);
  if (err != cudaSuccess) return err;
  gossip::pushsum_finish<<<grid, kBlock, 0, stream>>>(a, b, n_pad, ctrl);
  err = cudaGetLastError();
  if (!T || err != cudaSuccess) return err;
  return queue_rows(t, ctrl, rounds, n, target, f, n_pad, true, stream);
}

template <bool F, bool T = false>
cudaError_t queue_gossip(GossipPlanes a, GossipPlanes b, int8_t* mark,
                         const long long* keys, const int* dirs, Classes cls,
                         int n, int n_pad, int rounds, int rumor_target,
                         int suppress, int target, unsigned long long* words,
                         int* ctrl, Faults f, const int* n0, const int* a0,
                         const int* c0, int need_init, int device,
                         cudaStream_t stream, Tele t) {
  int grid = 0;
  cudaError_t err = cooperative_grid(gossip_rounds<F, T>, n_pad, device,
                                     gossip_grid_cache[T ? 2 : F ? 1 : 0], &grid);
  if (err != cudaSuccess) return err;
  if (T && grid != t.grid) return cudaErrorInvalidValue;
  int* init_words = (int*)(words + rounds + 1);
  if (F && f.death != nullptr)
    gossip::gossip_init_live<<<grid, kBlock, 0, stream>>>(
        n0, a0, c0, a, n_pad, f.death, f.revive, f.start - 1, init_words,
        (unsigned*)(init_words + 1), ctrl, need_init);
  else
    gossip::gossip_init<<<grid, kBlock, 0, stream>>>(
        n0, a0, c0, a, n_pad, init_words, (unsigned*)(init_words + 1), ctrl,
        target);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  void* args[] = {&a,      &b,       &mark,         &keys,    &dirs,
                  &cls,    &n,       &n_pad,        &rounds,  &rumor_target,
                  &suppress,         &target,       &words,   &ctrl, &f,
                  &t.part};
  err = cudaLaunchCooperativeKernel((const void*)gossip_rounds<F, T>, grid,
                                    kBlock, args, 0, stream);
  if (err != cudaSuccess) return err;
  gossip::gossip_finish<<<grid, kBlock, 0, stream>>>(a, b, n_pad, ctrl);
  err = cudaGetLastError();
  if (!T || err != cudaSuccess) return err;
  return queue_rows(t, ctrl, rounds, n, target, f, n_pad, false, stream);
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Both entry points zero the control words and queue three launches on
// `stream` of CUDA device `device` (the init launch, the persistent
// cooperative launch that runs every round, the finish launch, all three on
// the persistent grid, so no occupancy is asked after a device's first
// chunk) and return the first error (a cudaError_t), 0 if none. The
// arguments are those of csrc/fused_stencil.cu's entry points, then the
// failure model's: outputs and control words are allocated by the caller,
// the A planes receive the result, the B planes are the other half of the
// ping/pong pair; mark is int8[2 * n_pad]; dirs is int32[n_pad], every
// slot's directions word (ops/fused_stencil_hbm.dir_words); ctrl holds the
// chunk's control words: int32[2] (done, rounds executed), then 8 *
// (rounds + 2) bytes of scratch, the per-round barrier words (uint64,
// rounds of them, then the prologue's) and the init launch's total and
// ticket (int32 each); ctrl must be 8-byte aligned. `classes` is a host
// array of the n_classes sorted displacement classes. `faulted` picks the
// kernels' faulted instance, with the gate threshold (0: none), the death
// plane int32[n_pad] and the rounds' quorum needs int32[rounds] on the
// device (null: no crash model), the seed need of round start - 1, the
// chunk's first absolute round, the revival plane int32[n_pad] (null: no
// recovery model), whether a revived node resets, (push-sum) the initial
// term and global termination, and the Byzantine onset plane int32[n_pad]
// (pad lanes never; null: no adversary) with its mode (csrc/faults.cuh).
// tele (int32 [rounds, tele_grid, 10] of scratch; null: no telemetry) picks
// the telemetry instance, with faulted set and tele_grid the grid
// gossip_resident_grid gives it; its reduce writes the rows' [rounds, 10]
// float32 into rows, as a fourth launch; tmean is push-sum's true mean.

extern "C" int gossip_pushsum_resident_chunk(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* s_b, float* w_b, int* term_b,
    int* conv_b, int8_t* mark, const long long* keys, const int* dirs,
    int* ctrl, const int* classes, int n_classes, int kind, int n,
    int extra_node, int n_pad, int rounds, float delta, int term_rounds,
    int target, int faulted, unsigned thresh, const int* death,
    const int* needs, int need_init, int start, const int* revive, int reset,
    int init_term, int global, const int* byz, int byz_mode, int* tele,
    float* rows, int tele_grid, float tmean, int device, void* stream_ptr) {
  gossip::Lattice L;
  Classes cls;
  if (rounds < 0 || (tele && !faulted) ||
      !gossip::setup_lattice(kind, n, extra_node, classes, n_classes, &L, &cls))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // The control words, zeroed on the stream ahead of the chunk.
  err = zero_control(ctrl, rounds, stream);
  if (err != cudaSuccess) return (int)err;
  const PushSumPlanes a{s, w, term, conv};
  const PushSumPlanes b{s_b, w_b, term_b, conv_b};
  unsigned long long* words = (unsigned long long*)(ctrl + 2);
  const Faults f{thresh, death, needs, start, global, revive,
                 reset,  init_term, byz, byz_mode};
  const Tele t{tele, rows, tele_grid, tmean};
  return (int)(tele ? queue_pushsum<true, true>(
                          a, b, mark, keys, dirs, cls, n, n_pad, rounds, delta,
                          term_rounds, target, words, ctrl, f, s0, w0, t0, c0,
                          need_init, device, stream, t)
               : faulted
                   ? queue_pushsum<true>(a, b, mark, keys, dirs, cls, n, n_pad,
                                         rounds, delta, term_rounds, target,
                                         words, ctrl, f, s0, w0, t0, c0,
                                         need_init, device, stream, t)
                   : queue_pushsum<false>(a, b, mark, keys, dirs, cls, n, n_pad,
                                          rounds, delta, term_rounds, target,
                                          words, ctrl, f, s0, w0, t0, c0,
                                          need_init, device, stream, t));
}

extern "C" int gossip_gossip_resident_chunk(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int* count_b, int* active_b, int* conv_b, int8_t* mark,
    const long long* keys, const int* dirs, int* ctrl, const int* classes,
    int n_classes, int kind, int n, int extra_node, int n_pad, int rounds,
    int rumor_target, int suppress, int target, int faulted, unsigned thresh,
    const int* death, const int* needs, int need_init, int start,
    const int* revive, int reset, const int* byz, int byz_mode, int* tele,
    float* rows, int tele_grid, float tmean, int device, void* stream_ptr) {
  gossip::Lattice L;
  Classes cls;
  if (rounds < 0 || (tele && !faulted) ||
      !gossip::setup_lattice(kind, n, extra_node, classes, n_classes, &L, &cls))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  // The control words, zeroed on the stream ahead of the chunk.
  err = zero_control(ctrl, rounds, stream);
  if (err != cudaSuccess) return (int)err;
  const GossipPlanes a{count, active, conv};
  const GossipPlanes b{count_b, active_b, conv_b};
  unsigned long long* words = (unsigned long long*)(ctrl + 2);
  const Faults f{thresh, death, needs, start, 0, revive, reset, 0, byz, byz_mode};
  const Tele t{tele, rows, tele_grid, tmean};
  return (int)(tele ? queue_gossip<true, true>(
                          a, b, mark, keys, dirs, cls, n, n_pad, rounds,
                          rumor_target, suppress, target, words, ctrl, f, n0,
                          a0, c0, need_init, device, stream, t)
               : faulted
                   ? queue_gossip<true>(a, b, mark, keys, dirs, cls, n, n_pad,
                                        rounds, rumor_target, suppress, target,
                                        words, ctrl, f, n0, a0, c0, need_init,
                                        device, stream, t)
                   : queue_gossip<false>(a, b, mark, keys, dirs, cls, n, n_pad,
                                         rounds, rumor_target, suppress, target,
                                         words, ctrl, f, n0, a0, c0, need_init,
                                         device, stream, t));
}

// The grid of the telemetry instance's persistent launch (push-sum or
// gossip; `unused` keeps csrc/fused_pool.cu's gossip_pool_grid arguments)
// on an n_pad layout: the blocks whose partials a chunk's scratch holds.
// Returns the grid, or minus a cudaError_t.
extern "C" int gossip_resident_grid(int pushsum, int unused, int n_pad,
                                    int device) {
  (void)unused;
  if (n_pad < 1) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  int grid = 0;
  err = pushsum ? cooperative_grid(pushsum_rounds<true, true>, n_pad, device,
                                   pushsum_grid_cache[2], &grid)
                : cooperative_grid(gossip_rounds<true, true>, n_pad, device,
                                   gossip_grid_cache[2], &grid);
  return err == cudaSuccess ? grid : -(int)err;
}
