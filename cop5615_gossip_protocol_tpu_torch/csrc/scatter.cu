// Scatter delivery's push-sum and gossip rounds on flat [n] planes, for
// Hopper (sm_90a): the chunked engine's round on the implicit full
// topology and on explicit neighbour tables (imp2d/imp3d along their static
// extra edge, any lattice under delivery="scatter").
//
// Replaces no Pallas kernel: the JAX package runs this round as XLA ops
// (models/runner.py targets_and_gate, models/pushsum.py round_from_targets)
// with an XLA scatter-add for delivery (ops/delivery.py:22, deliver). Each
// sender i draws its target t(i) from the round's Threefry word at flat
// position i (csrc/scatter.cuh), and each node j adds its senders' values
// in ascending sender index, i1 < i2 < ... the senders with t = j:
//
//   gossip     inbox[j] = 0 + 1 + 1 + ...                  (int32, any order)
//   push-sum   s'[j] = s_keep[j] + s(i1) / 2 + s(i2) / 2 + ...
//              in_w[j] = 0 + w(i1) / 2 + w(i2) / 2 + ...,  w'[j] = w_keep[j] + in_w[j]
//
// then the term/conv latch (push-sum, received = in_w > 0) or the receipt
// count with receiver-side suppression (gossip), and a done flag once the
// converged count reaches the target. That is the op order of the JAX
// package's jitted round on the CPU, whose scatter-add runs in source
// order and where XLA folds s_keep + deliver(s) into one scatter-add onto
// s_keep (the w inbox it keeps, for `received`); an atomic float add would
// take another order on every run, so no float atomic is used anywhere.
//
// What bounds it on this card: random accesses and the grid barriers, not
// bytes. A push-sum round reads the state (s, w, term, conv: 13 bytes a
// node) and writes it back, but each send also costs three accesses at
// addresses no neighbour shares: its bucket's offset, its record's store
// and the counting atomic. At 1M each of those passes runs at the rate the
// card gives one PyTorch call for the same pattern (take, index_copy_,
// index_add_), and the three barriers a round are ~3 us each (PERF.md).
//
// Design: the form of csrc/fused_pool.cu. A chunk is one persistent
// cooperative launch that runs every round, with the grid barrier of
// csrc/persistent.cuh: every block leaves the round loop at the same
// round, at done or at the chunk's cap, so the rounds past convergence cost
// no launch. The grid is every block the SMs hold at once, fewer at small n
// (kNodesPerThread), and each block owns a contiguous slice of nodes
// (scatter.cuh Slices): as senders, as targets and for the bucket scan.
// Each thread folds the round keys from the run's key and the absolute
// round (scatter.cuh round_key), so a chunk copies nothing to the card and
// queues only the zeroing of its barrier words and the launch. The entry
// reads the status word (int32 [2]: rounds executed, done) and returns at
// once when done is set; block 0 writes it back at the end.
//
// Gossip: one pass and one barrier a round. A prologue sends round 0 (an
// int32 atomic add of 1 a send into inbox[0], exact in any order). Round r
// absorbs inbox[r & 1] (and zeroes what it read), then sends round r + 1
// from the node's new active flag into inbox[(r + 1) & 1]; the barrier word
// carries the converged count. A chunk that stops at done leaves round
// r + 1's sends staged: it zeroes that inbox before it returns.
//
// Push-sum: three barriers a round.
//   prologue  round 0's targets; each sender takes its rank in its target's
//             bucket from the counting atomic itself (rank = atomicAdd(&cnt
//             [t], 1)) and keeps (target, rank) as its ticket; barrier;
//   scan      each block scans its slice of the counts (each bucket's
//             offset in the slice) and publishes the slice's total; barrier;
//   place     each block adds up the totals of every block into shared
//             memory (the blocks' bases), then each sender writes one
//             16-byte record (index, s / 2, w / 2) at base + offset + rank
//             of its target's bucket, with no atomic; barrier;
//   absorb    each target loads its bucket into registers, sorts it by
//             sender index, sums it in that order onto its kept half and
//             absorbs (scatter.cuh pushsum_round, record_sum); it zeroes its
//             count, and in the same pass draws its round r + 1 target and
//             takes its rank there (a target depends on the round key and
//             the sender alone, never on the state); the barrier word
//             carries the converged count.
// Ordering: the counts are double-buffered by round parity, because the
// absorb reads cnt[r & 1][j] while other threads already add to
// cnt[(r + 1) & 1]. The tickets, offsets, totals and records need one
// plane each: each is written and read in passes a barrier apart, and
// rewritten only after the reads. The state is updated in place: a send is
// staged from the round-start s and w before the barrier that precedes the
// absorb. A chunk that stops at done leaves round r + 1's counts: it zeroes
// them before it returns, so the scratch is zero between chunks.
// scripts/scatter_round_variants.py times the other forms (an atomic cursor
// in the place pass, three 4-byte planes in place of the record, the scan
// form, the grid, the loads of several nodes issued together).
//
// Failure model (the JAX chunked engine's targets_and_gate, _freeze_dead
// and _done_predicate; push-sum's global termination): a template flag F
// picks each kernel's faulted instance, so the fault-free one keeps its
// code. A node sends round r + 1 only if its drop-gate word (csrc/faults.cuh)
// passes and it is alive then: push-sum takes its ticket, and gossip its
// send, in round r's absorb pass (the prologue: round start's), so a
// push-sum node sends iff it holds a ticket. A dead node's protocol state
// stays while push-sum's s and w absorb; the barrier word counts conv among
// the live nodes against the round's quorum need (ops/faults.quorum_needs).
// Under global termination no w inbox is kept apart (both halves' sums go
// onto the kept halves, as XLA folds them there), the barrier word counts
// the unstable nodes, term is left alone and conv is written after the last
// verdict. Under a recovery model a node is alive again from its revival
// round on, and where it rejoins with a reset (gossip always, push-sum under
// rejoin="fresh") every reader of its round-start state in its revival
// round takes the reset value (faults.cuh rejoins): its own absorb, and in
// push-sum the place pass that stages its send; gossip stages no send for a
// node that rejoins in the next round. The stored state stays un-reset
// until that round runs, so a chunk that ends just before it hands back
// the state JAX's resume expects. Under a Byzantine model (the JAX chunked
// engine's make_byz_send_fn and make_byz_override_fn) a push-sum adversary
// stages its mode's pair in the place pass (scatter.cuh make_send: the
// whole (s, w), the negated halves or the halves swapped) and keeps its
// honest halve; a live gossip adversary's state takes the mode's override
// at the end of its absorb, before its conv is counted and its next send
// drawn. The faulted push-sum instance flushes as the plain round does
// (csrc/chunk.cuh) and runs two blocks an SM.
//
// Robust aggregation, the health sentinel and the telemetry plane (the JAX
// chunked engine's make_robust_clip_fn, sentinel_bad and make_row_fn) are
// instances of their own, flags of the push-sum kernel's template beside F
// (kClip, kSentinel, kTele; gossip takes kTele alone), each with F: the
// instances without them keep their code. Under clip the absorb pass sums
// both of a node's inboxes from 0 (not onto its kept s half) and adds each
// to its kept half times the clip's scale with one fused multiply-add
// (scatter.cuh pushsum_round_clipped). Under the sentinel each block adds
// the w its nodes have just written and ORs a non-finite s or w, writes
// both into a slot of the round's parity before the absorb pass's barrier,
// and after it every block's first warp adds the blocks' partials in block
// order (csrc/telemetry.cuh grid_sum), so every block reaches the same
// verdict: |Σw - n| above the tolerance or a non-finite value ends the
// chunk at that round, which block 0 latches into the status's third word
// (NEVER while healthy). Under telemetry each block writes its partial
// counts and sums of the round into the telemetry scratch before that
// barrier (csrc/telemetry.cuh), sharing the sentinel's Σw partial where
// both run, and a reduce launch after the chunk sums them into the rows.
//
// Numerics: csrc/chunk.cuh's gossip absorb; built without fast math, with
// -fmad=false and denormals kept (utils/kernels.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "persistent.cuh"
#include "scatter.cuh"
#include "telemetry.cuh"
#include "threefry.cuh"

namespace {

using gossip::block_sum;
using gossip::cooperative_grid;
using gossip::kBlock;
using gossip::round_barrier;
using gossip::threefry_word;
using gossip::scatter::Send;
using gossip::scatter::Slices;
using gossip::scatter::Ticket;

constexpr int kScanItems = 4;
constexpr int kScanTile = kBlock * kScanItems;  // counts a scan step covers
// The most blocks a persistent launch takes: every block keeps every
// block's bucket base in shared memory.
constexpr int kMaxGrid = 2048;
// Nodes a thread owns at least: the grid is every block the SMs hold at
// once, and fewer when n / (kBlock * kNodesPerThread) is smaller, since
// each barrier costs more with more blocks.
constexpr int kNodesPerThread = 2;

struct Graph {
  const int* nbr;  // [n, max_deg] padded neighbour table; null on full
  const int* deg;  // [n] degrees; null on full
  int max_deg;
  int n;
};

// Sender i's target under the round key, or -1 when i does not send.
__device__ __forceinline__ int target_of(const Graph& g, uint32_t k1,
                                         uint32_t k2, int i) {
  if (g.nbr == nullptr)
    return gossip::scatter::target_full(threefry_word(k1, k2, (uint32_t)i), i,
                                        g.n);
  const int d = g.deg[i];
  if (d <= 0) return -1;
  return gossip::scatter::target_explicit(threefry_word(k1, k2, (uint32_t)i),
                                          g.nbr + (long long)i * g.max_deg, d);
}

__device__ __forceinline__ bool sends(const Graph& g, int j) {
  return g.nbr == nullptr || g.deg[j] > 0;
}

// A chunk's failure model (the kernels' F = true instance): the drop
// gate's threshold (0: no gate), each node's death round (null: no crash
// model) with each round's quorum need, global termination (push-sum), and
// under a recovery model each node's revival round (null: crash-stop),
// whether a revived node resets and push-sum's initial term.
struct Faults {
  uint32_t thresh;
  const int* death;  // int32 [n]
  const int* needs;  // int32 [rounds]
  int global;
  const int* revive;  // int32 [n]
  int reset, init_term;
  const int* byz;  // int32 [n]: Byzantine onset rounds
  int byz_mode;    // csrc/faults.cuh
  uint32_t dup;    // the dup gate's threshold (the dup instances)
  void* ring;      // the delay ring (the delay instances): float [D, 2, n]
                   // for push-sum, int32 [D, n] for gossip
  int delay;       // its depth D
};

// Whether node i is alive in absolute round `round`.
__device__ __forceinline__ bool alive(const Faults& f, int i, int round) {
  return gossip::node_alive(f.death, f.revive, i, round);
}

// Whether node i may send in absolute round `round` (gate key (g1, g2)):
// its gate word passes and it is alive.
__device__ __forceinline__ bool may_send(const Faults& f, uint32_t g1,
                                         uint32_t g2, int i, int round) {
  return gossip::gate_open(g1, g2, f.thresh, i) && alive(f, i, round);
}

// The gate key of absolute round `round` under the run's key.
__device__ __forceinline__ void round_gate_key(uint32_t key1, uint32_t key2,
                                               uint32_t round, uint32_t& g1,
                                               uint32_t& g2) {
  uint32_t r1, r2;
  gossip::scatter::round_key(key1, key2, round, r1, r2);
  gossip::gate_key(r1, r2, g1, g2);
}

// The kernels' instance flags beside F: robust_agg="clip", the health
// sentinel (push-sum), the telemetry rows, the dup gate and the delay ring.
constexpr int kClip = 1;
constexpr int kSentinel = 2;
constexpr int kTele = 4;
constexpr int kDup = 8;
constexpr int kDelay = 16;

// The dup key of absolute round `round` under the run's key.
__device__ __forceinline__ void round_dup_key(uint32_t key1, uint32_t key2,
                                              uint32_t round, uint32_t& d1,
                                              uint32_t& d2) {
  uint32_t r1, r2;
  gossip::scatter::round_key(key1, key2, round, r1, r2);
  gossip::scatter::dup_key(r1, r2, d1, d2);
}

// What the clip, sentinel and telemetry instances take beyond a chunk's
// failure model.
struct Extra {
  float tol;       // the sentinel's tolerance on |Σw - n|
  float* health;   // float [2 * kMaxGrid]: each block's Σw, a slot a parity,
                   // then int [2 * kMaxGrid]: its non-finite flags, then
                   // under the ring float [2 * kMaxGrid]: its w in flight
  int* tele;       // int32 [2 + rounds * grid * kPartials]: the chunk's
                   // (done, rounds executed), then the blocks' partials
  float tmean;     // push-sum's true mean, (n - 1) / 2
};

// Block b's telemetry partials of chunk round r.
__device__ __forceinline__ int* tele_part(const Extra& x, int r) {
  return x.tele + 2 +
         ((size_t)r * gridDim.x + blockIdx.x) * gossip::tele::kPartials;
}

// A node's drop-gate firing in absolute round `round` (gate key (g1, g2)),
// for the telemetry rows: a gate and a closed word, among the live.
__device__ __forceinline__ int gate_fired(const Faults& f, uint32_t g1,
                                          uint32_t g2, int j, bool live) {
  return f.thresh != 0u && live && !gossip::gate_open(g1, g2, f.thresh, j);
}

// Exclusive prefix of v over the block; total gets the block's sum.
__device__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_tot[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kBlock / 32 ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kBlock / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_tot[warp - 1] : 0;
  total = warp_tot[kBlock / 32 - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return before + x - v;
}

// The block's float sum of v in the telemetry order (csrc/telemetry.cuh:
// each warp folds by halves, then the warps add in order from 0.0), valid
// in thread 0.
__device__ float block_fsum(float v) {
  __shared__ float warp_sums[kBlock / 32];
  v = gossip::tele::warp_fold(v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kBlock / 32; ++w) t = gossip::flush(t + warp_sums[w]);
  __syncthreads();  // warp_sums is reused by the next round's call
  return t;
}

// The exclusive prefix of get(i) over [lo, hi) (block-uniform bounds),
// handed to put(i, prefix), in steps of kScanTile values, kScanItems
// consecutive values a thread; returns the range's total to every thread.
template <typename Get, typename Put>
__device__ __forceinline__ int scan_range(int lo, int hi, Get get, Put put) {
  int carry = 0;
  for (int step = lo; step < hi; step += kScanTile) {
    const int first = step + threadIdx.x * kScanItems;
    int v[kScanItems];
    int run = 0;
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      v[q] = first + q < hi ? get(first + q) : 0;
      run += v[q];
    }
    int total;
    int at = carry + block_exclusive_scan(run, total);
#pragma unroll
    for (int q = 0; q < kScanItems; ++q) {
      if (first + q < hi) put(first + q, at);
      at += v[q];
    }
    carry += total;
  }
  return carry;
}

// ------------------------------------------------------------------ gossip

// A gossip chunk's arguments, passed to its persistent kernel by value.
struct GossipChunk {
  int* count;  // the state planes, updated in place
  uint8_t* active;
  uint8_t* conv;
  Graph g;
  int* inbox;  // int32 [2 * n]: the receipts of each round parity
  uint32_t key1, key2, start;  // the run's key; the chunk's first round
  int rounds, rumor_target, suppress, target;
  unsigned long long* words;  // the barrier words: rounds, then the prologue's
  int* status;
  Faults f;
  Extra x;
};

__device__ __forceinline__ void gossip_send(const Graph& g, uint32_t k1,
                                            uint32_t k2, int i, int* inbox,
                                            int copies = 1) {
  const int t = target_of(g, k1, k2, i);
  if (t >= 0) atomicAdd(&inbox[t], copies);
}

// F: the failure model. A node sends round r + 1 only if its gate word
// passes and it is alive then; a dead node's count, active and conv stay
// as they were (its receipts are dropped), and the verdict is the quorum
// need of the round among the live nodes. F = false is the fault-free
// kernel, with none of these loads or tests. X (with F): kTele, the
// telemetry rows' partials of each round; kDup, a dup-gated sender's send
// adds 2 (csrc/scatter.cuh dup_fires); kDelay, each node's receipts go
// through the ring: round r reads its word of slot r % D, writes the
// round's receipts there and absorbs what it read (a dead node's reads are
// dropped, its receipts kept in the ring).
template <bool F, int X = 0>
__global__ void __launch_bounds__(kBlock) gossip_rounds(GossipChunk c) {
  constexpr bool T = (X & kTele) != 0;
  constexpr bool Dup = (X & kDup) != 0;
  constexpr bool L = (X & kDelay) != 0;
  // Every block reads the same status before block 0 writes it, at the end.
  if (c.status[1] || c.rounds == 0) return;
  const int n = c.g.n;
  const int first = blockIdx.x * kBlock + threadIdx.x;
  const int stride = gridDim.x * kBlock;
  {
    uint32_t k1, k2, g1 = 0u, g2 = 0u, d1 = 0u, d2 = 0u;
    gossip::scatter::round_key(c.key1, c.key2, c.start, k1, k2);
    if (F) gossip::gate_key(k1, k2, g1, g2);
    if (Dup) gossip::scatter::dup_key(k1, k2, d1, d2);
    for (int i = first; i < n; i += stride)
      if (c.active[i] &&
          (!F || (may_send(c.f, g1, g2, i, (int)c.start) &&
                  !gossip::rejoins(c.f.revive, c.f.reset, i, (int)c.start))))
        gossip_send(c.g, k1, k2, i, c.inbox,
                    Dup && gossip::scatter::dup_fires(d1, d2, c.f.dup, i) ? 2 : 1);
  }
  round_barrier(c.words + c.rounds, 0);
  int executed = 0;
  bool done = false;
  while (!done && executed < c.rounds) {
    const int r = executed;
    const int round = (int)c.start + r;  // absolute
    int* in = c.inbox + (size_t)(r & 1) * n;
    int* out = r + 1 < c.rounds ? c.inbox + (size_t)((r + 1) & 1) * n : nullptr;
    uint32_t k1, k2, g1 = 0u, g2 = 0u;
    gossip::scatter::round_key(c.key1, c.key2, c.start + r + 1, k1, k2);
    if (F) gossip::gate_key(k1, k2, g1, g2);
    uint32_t nd1 = 0u, nd2 = 0u;  // the next round's dup key (Dup)
    if (Dup) gossip::scatter::dup_key(k1, k2, nd1, nd2);
    uint32_t rg1 = 0u, rg2 = 0u;  // this round's gate key (T)
    if (T && c.f.thresh) round_gate_key(c.key1, c.key2, round, rg1, rg2);
    uint32_t rd1 = 0u, rd2 = 0u;  // this round's dup key (T with Dup)
    if (T && Dup) round_dup_key(c.key1, c.key2, round, rd1, rd2);
    int* ring = L ? (int*)c.f.ring +
                        (size_t)gossip::scatter::ring_slot(round, c.f.delay) * n
                  : nullptr;
    gossip::tele::Acc acc;
    int converged = 0;
    for (int j = first; j < n; j += stride) {
      int got = in[j];
      if (got) in[j] = 0;
      if constexpr (L) {
        // The round's receipts go into the ring; what it held arrives.
        const int arrive = ring[j];
        ring[j] = got;
        got = arrive;
      }
      const bool live = !F || alive(c.f, j, round);
      // A node that rejoins this round starts it at (0, inactive, 0).
      const bool rn = F && gossip::rejoins(c.f.revive, c.f.reset, j, round);
      int cnt, act, cv;
      if (live) {
        cv = gossip::gossip_absorb(
            [&] { return rn ? 0 : (int)c.conv[j]; },
            [&] { return rn ? 0 : c.count[j]; },
            [&] { return rn ? 0 : (int)c.active[j]; }, false, got,
            c.rumor_target, c.suppress, cnt, act);
        if (F)
          gossip::gossip_override(c.f.byz_mode,
                                  gossip::byzantine_in(c.f.byz, j, round), cnt,
                                  act, cv);
        c.count[j] = cnt;
        c.active[j] = (uint8_t)act;
        c.conv[j] = (uint8_t)cv;
      } else {
        act = c.active[j];
        cv = c.conv[j];
      }
      // A node that rejoins next round is inactive then.
      if (out && act &&
          (!F || (may_send(c.f, g1, g2, j, round + 1) &&
                  !gossip::rejoins(c.f.revive, c.f.reset, j, round + 1))))
        gossip_send(c.g, k1, k2, j, out,
                    Dup && gossip::scatter::dup_fires(nd1, nd2, c.f.dup, j) ? 2 : 1);
      converged += live ? cv : 0;
      if constexpr (T) {
        using namespace gossip::tele;
        acc.i[kConv] += cv;
        acc.i[kLive] += live;
        acc.i[kConvAlive] += live ? cv : 0;
        acc.i[kActive] += act;
        acc.i[kDrops] += gate_fired(c.f, rg1, rg2, j, live);
        acc.i[kRevived] += c.f.revive != nullptr && c.f.revive[j] == round;
        acc.i[kByz] += gossip::byzantine_in(c.f.byz, j, round);
        if (Dup)
          acc.dups += live && gossip::scatter::dup_fires(rd1, rd2, c.f.dup, j);
      }
    }
    if constexpr (T)
      gossip::tele::block_partials<kBlock, Dup>(acc, tele_part(c.x, r));
    const int total = round_barrier(c.words + r, block_sum(converged));
    done = total >= (F && c.f.death ? c.f.needs[r] : c.target);
    ++executed;
  }
  // Stopped at done before the cap: round `executed`'s sends are staged.
  if (executed < c.rounds) {
    int* staged = c.inbox + (size_t)(executed & 1) * n;
    for (int j = first; j < n; j += stride) staged[j] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    c.status[0] += executed;
    c.status[1] = done ? 1 : 0;
    if (T) {
      c.x.tele[0] = done ? 1 : 0;
      c.x.tele[1] = executed;
    }
  }
}

// ---------------------------------------------------------------- push-sum

struct PushSumChunk {
  float* s;  // the state planes, updated in place
  float* w;
  int* term;
  uint8_t* conv;
  Graph g;
  int* cnt;      // int32 [2 * n]: the bucket counts of each round parity
  Ticket* tick;  // [n]: each sender's next-round (target, rank)
  int* loc;      // [n]: each bucket's offset inside its block's slice
  int* tot;      // [kMaxGrid]: each block's slice total
  Send* rec;     // [n]: the staged sends, bucket after bucket
  uint32_t key1, key2, start;  // the run's key; the chunk's first round
  int rounds;
  float delta;
  int term_rounds, target;
  unsigned long long* words;  // the barrier words: 3 a round, then the prologue's
  int* status;
  Faults f;
  Extra x;
};

// Sender i's target under (k1, k2) and its rank in that bucket of cnt.
__device__ __forceinline__ Ticket count_send(const Graph& g, uint32_t k1,
                                             uint32_t k2, int i, int* cnt) {
  const int t = target_of(g, k1, k2, i);
  return Ticket{t, t >= 0 ? atomicAdd(&cnt[t], 1) : 0};
}

// Three blocks an SM (80 registers): with no minimum, ptxas gives this
// kernel 64 registers and spills (scripts/scatter_round_variants.py, lb0).
// The faulted instance spills at 80 (its gate key and the node's death
// round and ticket stay live through the absorb): two blocks an SM.
// F: the failure model, as in gossip_rounds. A sender takes a ticket for
// round r + 1 only if its gate word passes and it is alive then, so it
// sends in a round iff it holds a ticket (target >= 0), and a node that
// does not send keeps its whole mass. A dead node's term and conv stay as
// they were while its s and w absorb. Under global termination the barrier
// word counts the unstable nodes, term is left alone, and conv is written
// after the last verdict: 1 everywhere if it ended the run, else 0 (also
// where the sentinel's trip ended it).
// X (with F): the clip, sentinel and telemetry instances (kClip, kSentinel,
// kTele; see the header). Under clip global termination is not read, as
// the plain round's clipped absorb does not read it. kDup and kDelay: the
// dup and delay instances, where a node's inboxes sum from 0 (a dup-gated
// sender's record carries its dup bit in its index word and adds into a
// second inbox, the two then added) and the kept halves add them unfolded
// (scatter.cuh record_inbox, pushsum_round_inbox); under kDelay each node
// reads its words of ring slot round % D, writes its fresh inboxes there
// and absorbs what it read; with the sentinel (kDelay | kSentinel) the w
// in flight counts in Σw, each node's D words added in slot order, and a
// non-finite word in the ring trips it.
template <bool F, int X = 0>
__global__ void __launch_bounds__(kBlock, F ? 2 : 3)
    pushsum_rounds(PushSumChunk c) {
  constexpr bool C = (X & kClip) != 0;
  constexpr bool S = (X & kSentinel) != 0;
  constexpr bool T = (X & kTele) != 0;
  constexpr bool Dup = (X & kDup) != 0;
  constexpr bool L = (X & kDelay) != 0;
  if (c.status[1] || c.rounds == 0) return;
  __shared__ int base[kMaxGrid];  // every block's bucket base
  const int n = c.g.n;
  const Slices sl = gossip::scatter::make_slices(n, gridDim.x);
  const int lo = gossip::scatter::slice_lo(sl, blockIdx.x);
  const int hi = gossip::scatter::slice_hi(sl, blockIdx.x);
  const bool global = F && !C && c.f.global;
  int trip_round = -1;  // the sentinel's first unhealthy round (S)
  // (S) the global verdict of the last round apart from a trip: conv and
  // the rows' latch read it, as the plain round's conv does.
  bool global_done = false;
  {
    uint32_t k1, k2, g1 = 0u, g2 = 0u;
    gossip::scatter::round_key(c.key1, c.key2, c.start, k1, k2);
    if (F) gossip::gate_key(k1, k2, g1, g2);
    for (int i = lo + threadIdx.x; i < hi; i += kBlock)
      c.tick[i] = !F || may_send(c.f, g1, g2, i, (int)c.start)
                      ? count_send(c.g, k1, k2, i, c.cnt)
                      : Ticket{-1, 0};
  }
  round_barrier(c.words + 3 * c.rounds, 0);
  int executed = 0;
  bool done = false;
  while (!done && executed < c.rounds) {
    const int r = executed;
    const int round = (int)c.start + r;  // absolute
    int* cnt = c.cnt + (size_t)(r & 1) * n;
    int* cnt_next = c.cnt + (size_t)((r + 1) & 1) * n;

    // Scan: each bucket's offset in the slice, and the slice's total.
    const int total = scan_range(
        lo, hi, [&](int j) { return cnt[j]; },
        [&](int j, int at) { c.loc[j] = at; });
    if (threadIdx.x == 0) c.tot[blockIdx.x] = total;
    round_barrier(c.words + 3 * r, 0);

    // Place: the blocks' bases, then each sender's record in its slot.
    scan_range(
        0, gridDim.x, [&](int b) { return c.tot[b]; },
        [&](int b, int at) { base[b] = at; });
    __syncthreads();
    uint32_t d1 = 0u, d2 = 0u;  // the round's dup key (Dup)
    if (Dup) round_dup_key(c.key1, c.key2, (uint32_t)round, d1, d2);
    for (int i = lo + threadIdx.x; i < hi; i += kBlock) {
      const Ticket tk = c.tick[i];
      if (tk.target < 0) continue;
      const int pos = base[gossip::scatter::slice_of(sl, tk.target)] +
                      c.loc[tk.target] + tk.rank;
      // A fresh rejoin sends from its reset state (s = i, w = 0); an
      // adversary sends its mode's pair.
      const bool rn = F && gossip::rejoins(c.f.revive, c.f.reset, i, round);
      Send v = gossip::scatter::make_send<F>(
          i, rn ? (float)i : c.s[i], rn ? 0.0f : c.w[i],
          F && gossip::byzantine_in(c.f.byz, i, round) ? c.f.byz_mode : 0);
      if (Dup)
        v.idx = gossip::scatter::dup_index(
            i, gossip::scatter::dup_fires(d1, d2, c.f.dup, i));
      gossip::scatter::store_send(c.rec + pos, v);
    }
    round_barrier(c.words + 3 * r + 1, 0);

    // Absorb, and the next round's targets and ranks.
    const bool next = r + 1 < c.rounds;
    uint32_t k1, k2, g1 = 0u, g2 = 0u;
    gossip::scatter::round_key(c.key1, c.key2, c.start + r + 1, k1, k2);
    if (F) gossip::gate_key(k1, k2, g1, g2);
    uint32_t rg1 = 0u, rg2 = 0u;  // this round's gate key (T)
    if (T && c.f.thresh) round_gate_key(c.key1, c.key2, round, rg1, rg2);
    const int mine = base[blockIdx.x];
    // The round's ring slot, s plane then w plane (L).
    float* ring = L ? (float*)c.f.ring +
                          (size_t)gossip::scatter::ring_slot(round, c.f.delay) * 2 * n
                    : nullptr;
    gossip::tele::Acc acc;  // the round's sums over the thread's nodes (S, T)
    int nonfinite = 0;      // (S)
    float in_flight = 0.0f;  // the ring's w over the thread's nodes (S with L)
    int converged = 0;
    for (int j = lo + threadIdx.x; j < hi; j += kBlock) {
      // The loads first (count, offset, own state), then the next round's
      // atomic, then the bucket and its sums; the stores last. Under the
      // ring, its slot's words come first of all: read after the bucket's
      // sums, they wait out the bucket's chain (2.7x the round at 1M full,
      // scripts/scatter_ring_variants.py).
      float arrive_s = 0.0f, arrive_w = 0.0f;  // (L)
      if constexpr (L) {
        arrive_s = ring[j];
        arrive_w = ring[n + j];
      }
      const int k = cnt[j];
      const int at = mine + c.loc[j];
      // A fresh rejoin starts the round at (j, 0, initial term, 0).
      float s_t = c.s[j], w_t = c.w[j];
      int t_old = c.term[j], c_in = c.conv[j];
      if (F)
        gossip::rejoin_pushsum(gossip::rejoins(c.f.revive, c.f.reset, j, round), j,
                               c.f.init_term, s_t, w_t, t_old, c_in);
      const bool c_old = c_in != 0;
      const bool sent = F ? c.tick[j].target >= 0 : sends(c.g, j);
      const bool live = !F || alive(c.f, j, round);
      const Ticket tk =
          next && (!F || may_send(c.f, g1, g2, j, round + 1))
              ? count_send(c.g, k1, k2, j, cnt_next)
              : Ticket{-1, 0};
      float s_new, w_new;
      int t_new, cv;
      if constexpr (Dup || L) {
        // The inboxes from 0; under the ring the fresh ones go in and what
        // the slot held is absorbed.
        float in_s, in_w;
        gossip::scatter::record_inbox<Dup>(c.rec + at, k, in_s, in_w);
        if constexpr (L) {
          ring[j] = in_s;
          ring[n + j] = in_w;
          in_s = arrive_s;
          in_w = arrive_w;
        }
        if constexpr (S && L) {
          // The sentinel's view of node j's words in the ring after the
          // round: their w in slot order from 0, and whether any is not
          // finite (ops/scatter.ring_node_sums).
          float node_w = 0.0f;
          for (int d = 0; d < c.f.delay; ++d) {
            const float* slot = (const float*)c.f.ring + (size_t)d * 2 * n;
            const float s_d = slot[j], w_d = slot[n + j];
            node_w = gossip::flush(node_w + w_d);
            nonfinite |= !(isfinite(s_d) && isfinite(w_d));
          }
          in_flight = gossip::flush(in_flight + node_w);
        }
        if (global) {
          float s_keep, w_keep;
          gossip::keep_flushed<true>(s_t, w_t, sent, s_keep, w_keep);
          s_new = gossip::flush(s_keep + in_s);
          w_new = gossip::flush(w_keep + in_w);
          cv = gossip::unstable_global(s_t, w_t, s_new, w_new, c.delta) ? 1 : 0;
        } else {
          if constexpr (C)
            cv = gossip::scatter::pushsum_round_clipped(
                s_t, w_t, t_old, c_old, sent,
                [&](float& a, float& b) {
                  a = in_s;
                  b = in_w;
                },
                c.delta, c.term_rounds, s_new, w_new, t_new);
          else
            cv = gossip::scatter::pushsum_round_inbox(
                s_t, w_t, t_old, c_old, sent, in_s, in_w, c.delta,
                c.term_rounds, s_new, w_new, t_new);
          t_new = gossip::frozen(live, t_new, t_old);
          cv = gossip::frozen(live, cv, c_old ? 1 : 0);
          c.term[j] = t_new;
          c.conv[j] = (uint8_t)cv;
        }
      } else if (global) {
        // Both halves' sums onto the kept halves (nothing reads a w inbox).
        float acc_s, acc_w;
        gossip::keep_flushed<true>(s_t, w_t, sent, acc_s, acc_w);
        gossip::scatter::record_sum<true>(c.rec + at, k, acc_s, acc_w);
        s_new = acc_s;
        w_new = acc_w;
        cv = gossip::unstable_global(s_t, w_t, s_new, w_new, c.delta) ? 1 : 0;
      } else {
        const auto add_bucket = [&](float& a, float& b) {
          gossip::scatter::record_sum<F>(c.rec + at, k, a, b);
        };
        if constexpr (C)
          cv = gossip::scatter::pushsum_round_clipped(
              s_t, w_t, t_old, c_old, sent, add_bucket, c.delta,
              c.term_rounds, s_new, w_new, t_new);
        else
          cv = gossip::scatter::pushsum_round<F>(s_t, w_t, t_old, c_old, sent,
                                                 add_bucket, c.delta,
                                                 c.term_rounds, s_new, w_new,
                                                 t_new);
        if (F) {
          t_new = gossip::frozen(live, t_new, t_old);
          cv = gossip::frozen(live, cv, c_old ? 1 : 0);
        }
        c.term[j] = t_new;
        c.conv[j] = (uint8_t)cv;
      }
      if (k > 0) cnt[j] = 0;
      c.s[j] = s_new;
      c.w[j] = w_new;
      if (next) c.tick[j] = tk;
      converged += live ? cv : 0;
      if constexpr (S || T) acc.add(gossip::tele::kW, w_new);
      if constexpr (S) nonfinite |= !(isfinite(s_new) && isfinite(w_new));
      if constexpr (T) {
        // The row of the round's output state: under global termination
        // conv is 0 on every node until the verdict's latch.
        using namespace gossip::tele;
        const int conv_now = global ? 0 : cv;
        acc.i[kConv] += conv_now;
        acc.i[kLive] += live;
        acc.i[kConvAlive] += live ? conv_now : 0;
        acc.i[kDrops] += gate_fired(c.f, rg1, rg2, j, live);
        acc.i[kRevived] += c.f.revive != nullptr && c.f.revive[j] == round;
        acc.i[kByz] += gossip::byzantine_in(c.f.byz, j, round);
        if (Dup) acc.dups += live && gossip::scatter::dup_fires(d1, d2, c.f.dup, j);
        if (conv_now) acc.add(kErr, chunked_err(s_new, w_new, c.x.tmean));
        if (global) acc.add(kErrAll, chunked_err(s_new, w_new, c.x.tmean));
      }
    }
    if constexpr (T) {
      int* part = tele_part(c.x, r);
      gossip::tele::block_partials<kBlock, Dup>(acc, part);
      // The sentinel's Σw partial is the row's (written before the sync
      // that ends block_partials).
      if (S && threadIdx.x == 0)
        acc.f[gossip::tele::kW - gossip::tele::kInts] =
            __int_as_float(part[gossip::tele::kW]);
    } else if constexpr (S) {
      acc.f[gossip::tele::kW - gossip::tele::kInts] = block_fsum(
          acc.f[gossip::tele::kW - gossip::tele::kInts]);
    }
    if constexpr (S && L) in_flight = block_fsum(in_flight);
    if constexpr (S) {
      nonfinite = __syncthreads_or(nonfinite);
      if (threadIdx.x == 0) {
        c.x.health[(r & 1) * kMaxGrid + blockIdx.x] =
            acc.f[gossip::tele::kW - gossip::tele::kInts];
        ((int*)c.x.health)[(2 + (r & 1)) * kMaxGrid + blockIdx.x] = nonfinite;
        if (L) c.x.health[(4 + (r & 1)) * kMaxGrid + blockIdx.x] = in_flight;
      }
    }
    const int sum = round_barrier(c.words + 3 * r + 2, block_sum(converged));
    if (global) {
      done = sum == 0;  // the round's unstable count
      if constexpr (S) global_done = done;
    } else
      done = sum >= (F && c.f.death ? c.f.needs[r] : c.target);
    if constexpr (S) {
      // Every block adds the blocks' partials in block order: one verdict.
      __shared__ int tripped;
      if (threadIdx.x < 32) {
        float total_w =
            gossip::tele::grid_sum(c.x.health + (r & 1) * kMaxGrid, gridDim.x);
        if constexpr (L)
          total_w = gossip::flush(
              total_w + gossip::tele::grid_sum(
                            c.x.health + (4 + (r & 1)) * kMaxGrid, gridDim.x));
        const int* flags = (const int*)c.x.health + (2 + (r & 1)) * kMaxGrid;
        int bad = 0;
        for (int b = threadIdx.x; b < (int)gridDim.x; b += 32)
          bad |= __ldcg(flags + b);
        bad = __any_sync(0xffffffffu, bad);
        if (threadIdx.x == 0)
          tripped = bad || fabsf(total_w - (float)n) > c.x.tol;
      }
      __syncthreads();
      if (tripped) {
        done = true;
        trip_round = round;
      }
    }
    ++executed;
  }
  // Stopped at done before the cap: round `executed`'s counts are staged.
  if (executed < c.rounds) {
    int* staged = c.cnt + (size_t)(executed & 1) * n;
    for (int j = lo + threadIdx.x; j < hi; j += kBlock) staged[j] = 0;
  }
  // Global termination: every node converged iff the last round's verdict
  // ended the run (a sentinel's trip ends it with that verdict as it was).
  const bool latched = S ? global_done : done;
  if (global)
    for (int j = lo + threadIdx.x; j < hi; j += kBlock) c.conv[j] = latched ? 1 : 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    c.status[0] += executed;
    c.status[1] = done ? 1 : 0;
    if (S && trip_round >= 0) c.status[2] = trip_round;
    if (T) {
      c.x.tele[0] = latched ? 1 : 0;
      c.x.tele[1] = executed;
    }
  }
}

// The persistent grid of each kernel instance, asked once a device, by its
// template arguments: the faulted flag F and the flags X (kClip .. kDelay).
int pushsum_grid_cache[2][32][64];
int gossip_grid_cache[2][32][64];

// fn(the instance <F, X>, its grid cache).
template <bool F, int X, typename Fn>
cudaError_t pushsum_with(Fn fn) {
  return fn(pushsum_rounds<F, X>, pushsum_grid_cache[F][X]);
}

template <bool F, int X, typename Fn>
cudaError_t gossip_with(Fn fn) {
  return fn(gossip_rounds<F, X>, gossip_grid_cache[F][X]);
}

// The persistent grid of `kernel` at n nodes: every block the SMs hold at
// once, fewer at small n (kNodesPerThread), at most kMaxGrid.
template <typename Kernel>
cudaError_t grid_of(Kernel kernel, int n, int device, int* cache, int* grid) {
  cudaError_t err = cooperative_grid(
      kernel, (int)(((long long)n + kNodesPerThread - 1) / kNodesPerThread),
      device, cache, grid);
  if (*grid > kMaxGrid) *grid = kMaxGrid;
  return err;
}

// Queues one chunk of `kernel`: the zeroing of its barrier words (and of
// the telemetry header, whose rows are then zero if no round runs), then
// the persistent launch. A telemetry instance's grid must be the one its
// scratch was sized for (`want`, from gossip_scatter_grid).
template <typename Kernel, typename Chunk>
cudaError_t launch(Kernel kernel, Chunk c, int n, int words, int* cache,
                   int device, cudaStream_t stream, int want = 0) {
  int grid = 0;
  cudaError_t err = grid_of(kernel, n, device, cache, &grid);
  if (err != cudaSuccess) return err;
  if (want && grid != want) return cudaErrorInvalidValue;
  // The chunk's barrier words, zeroed on the stream ahead of it.
  err = cudaMemsetAsync(c.words, 0, 8 * (size_t)words, stream);
  if (err != cudaSuccess) return err;
  if (c.x.tele != nullptr) {
    err = cudaMemsetAsync(c.x.tele, 0, 8, stream);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&c};
  return cudaLaunchCooperativeKernel((const void*)kernel, grid, kBlock, args, 0,
                                     stream);
}

// fn(kernel, its grid cache) for the push-sum instance of the failure model
// (faulted) and the flags x: the ladder reaches the fault-free kernel, the
// faulted one, and with it clip, the sentinel or telemetry, and telemetry
// with clip or with the sentinel (clip and the sentinel exclude each other,
// config.py); and the dup, delay and dup-and-delay instances, each alone,
// with clip, telemetry, or both, and the delay instance with the sentinel,
// alone or with telemetry (the sentinel excludes the dup gate, config.py).
template <int D, typename Fn>
cudaError_t pushsum_dd_instance(int x, Fn fn) {
  switch (x & ~(kDup | kDelay)) {
    case 0: return pushsum_with<true, D>(fn);
    case kClip: return pushsum_with<true, D | kClip>(fn);
    case kTele: return pushsum_with<true, D | kTele>(fn);
    case kTele | kClip: return pushsum_with<true, D | kTele | kClip>(fn);
    default: break;
  }
  if constexpr (D == kDelay) {
    switch (x & ~kDelay) {
      case kSentinel: return pushsum_with<true, kDelay | kSentinel>(fn);
      case kTele | kSentinel:
        return pushsum_with<true, kDelay | kTele | kSentinel>(fn);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

template <typename Fn>
cudaError_t pushsum_instance(int faulted, int x, Fn fn) {
  if (!faulted) return x ? cudaErrorInvalidValue : pushsum_with<false, 0>(fn);
  switch (x & (kDup | kDelay)) {
    case kDup: return pushsum_dd_instance<kDup>(x, fn);
    case kDelay: return pushsum_dd_instance<kDelay>(x, fn);
    case kDup | kDelay: return pushsum_dd_instance<kDup | kDelay>(x, fn);
    default: break;
  }
  switch (x) {
    case 0: return pushsum_with<true, 0>(fn);
    case kClip: return pushsum_with<true, kClip>(fn);
    case kSentinel: return pushsum_with<true, kSentinel>(fn);
    case kTele: return pushsum_with<true, kTele>(fn);
    case kTele | kClip: return pushsum_with<true, kTele | kClip>(fn);
    case kTele | kSentinel: return pushsum_with<true, kTele | kSentinel>(fn);
    default: return cudaErrorInvalidValue;
  }
}

// The gossip instance of the failure model and the flags x (kTele, kDup,
// kDelay; every combination with faulted set).
template <typename Fn>
cudaError_t gossip_instance(int faulted, int x, Fn fn) {
  if (!faulted) return x ? cudaErrorInvalidValue : gossip_with<false, 0>(fn);
  switch (x) {
    case 0: return gossip_with<true, 0>(fn);
    case kTele: return gossip_with<true, kTele>(fn);
    case kDup: return gossip_with<true, kDup>(fn);
    case kDelay: return gossip_with<true, kDelay>(fn);
    case kDup | kDelay: return gossip_with<true, kDup | kDelay>(fn);
    case kTele | kDup: return gossip_with<true, kTele | kDup>(fn);
    case kTele | kDelay: return gossip_with<true, kTele | kDelay>(fn);
    case kTele | kDup | kDelay:
      return gossip_with<true, kTele | kDup | kDelay>(fn);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Each entry point queues one chunk on `stream` of CUDA device `device`:
// the zeroing of its barrier words and one persistent cooperative launch
// that runs up to `rounds` rounds from absolute round `start`, round r
// under the fold_in key of round start + r under the run's key (key1,
// key2) (ops/fused.round_keys). The state planes are
// updated in place; status is int32 [2] (rounds executed, done) on the
// device; the scratch planes (push-sum cnt, gossip inbox: int32 [2 * n])
// must be zero and are left zero; words holds 3 * rounds + 1 (push-sum) or
// rounds + 1 (gossip) uint64 barrier words. Under a recovery model revive is
// the int32 [n] revival plane (else null), reset whether a revived node
// resets and init_term push-sum's initial term. Under a Byzantine model byz
// is the int32 [n] onset plane (else null) and byz_mode its mode
// (csrc/faults.cuh). Push-sum's robust_clip and sentinel (with its
// tolerance and health, float [2 * kMaxGrid], int [2 * kMaxGrid] and float
// [2 * kMaxGrid] of scratch) and either protocol's tele (int32 [2 + rounds * tele_grid *
// kPartials] of scratch, tele_grid the grid gossip_scatter_grid gives the
// instance) pick the instances of their own, with faulted set; under tele
// the reduce of the rows into rows (float32 [rounds, 10]) is queued after
// the chunk, and tmean is push-sum's true mean. dup (the dup gate's
// threshold, 0 for none) and ring (the delay ring of depth delay, null for
// none: float [delay, 2, n] for push-sum, int32 [delay, n] for gossip, read
// and written in place) pick the dup and delay instances, with faulted set.
// Returns the first error (a cudaError_t), 0 if none. A chunk of no round
// queues nothing.

extern "C" int gossip_pushsum_scatter_chunk(
    float* s, float* w, int* term, uint8_t* conv, const int* nbr, const int* deg,
    int max_deg, int n, int* cnt, void* tick, int* loc, int* tot, void* rec,
    unsigned long long* words, int* status, unsigned key1, unsigned key2,
    unsigned start, int rounds, float delta, int term_rounds, int target,
    int faulted, unsigned thresh, const int* death, const int* needs,
    const int* revive, int reset, int init_term, int global, const int* byz,
    int byz_mode, unsigned dup, void* ring, int delay, int robust_clip,
    int sentinel, float tol, float* health, int* tele, float* rows,
    int tele_grid, float tmean, int device, void* stream_ptr) {
  if (n < 1 || rounds < 0) return (int)cudaErrorInvalidValue;
  if (rounds == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const PushSumChunk c{s, w, term, conv, Graph{nbr, deg, max_deg, n},
                       cnt, (Ticket*)tick, loc, tot, (Send*)rec, key1, key2,
                       start, rounds, delta, term_rounds, target, words,
                       status, Faults{thresh, death, needs, global, revive,
                                      reset, init_term, byz, byz_mode, dup,
                                      ring, delay},
                       Extra{tol, health, tele, tmean}};
  const int x = (robust_clip ? kClip : 0) | (sentinel ? kSentinel : 0) |
                (tele != nullptr ? kTele : 0) | (dup ? kDup : 0) |
                (ring != nullptr ? kDelay : 0);
  err = pushsum_instance(faulted, x, [&](auto kernel, int* cache) {
    return launch(kernel, c, n, 3 * rounds + 1, cache, device, stream,
                  tele_grid);
  });
  if (err != cudaSuccess || tele == nullptr) return (int)err;
  const gossip::tele::RowArgs a{tele + 2, tele, rows, tele_grid, rounds, n,
                                target, death ? needs : nullptr, n, 1,
                                global && !robust_clip, dup != 0};
  return (int)gossip::tele::queue_rows(a, stream);
}

extern "C" int gossip_gossip_scatter_chunk(
    int* count, uint8_t* active, uint8_t* conv, const int* nbr, const int* deg,
    int max_deg, int n, int* inbox, unsigned long long* words, int* status,
    unsigned key1, unsigned key2, unsigned start, int rounds, int rumor_target,
    int suppress, int target, int faulted, unsigned thresh, const int* death,
    const int* needs, const int* revive, int reset, const int* byz,
    int byz_mode, unsigned dup, void* ring, int delay, int* tele, float* rows,
    int tele_grid, int device, void* stream_ptr) {
  if (n < 1 || rounds < 0) return (int)cudaErrorInvalidValue;
  if (rounds == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const GossipChunk c{count, active, conv, Graph{nbr, deg, max_deg, n},
                      inbox, key1, key2, start, rounds, rumor_target, suppress,
                      target, words, status,
                      Faults{thresh, death, needs, 0, revive, reset, 0, byz,
                             byz_mode, dup, ring, delay},
                      Extra{0.0f, nullptr, tele, 0.0f}};
  const int x = (tele != nullptr ? kTele : 0) | (dup ? kDup : 0) |
                (ring != nullptr ? kDelay : 0);
  err = gossip_instance(faulted, x, [&](auto kernel, int* cache) {
    return launch(kernel, c, n, rounds + 1, cache, device, stream, tele_grid);
  });
  if (err != cudaSuccess || tele == nullptr) return (int)err;
  const gossip::tele::RowArgs a{tele + 2, tele, rows, tele_grid, rounds, n,
                                target, death ? needs : nullptr, n, 0, 0,
                                dup != 0};
  return (int)gossip::tele::queue_rows(a, stream);
}

// The grid of a telemetry instance's persistent launch at n nodes (its
// scratch holds a row of partials a block a round): push-sum's by
// (faulted, flags: 1 clip, 2 sentinel, 4 telemetry, 8 dup, 16 delay),
// gossip's by (faulted, flags & (4 | 8 | 16)). Returns the grid, or minus a
// cudaError_t.
extern "C" int gossip_scatter_grid(int pushsum, int faulted, int flags, int n,
                                   int device) {
  if (n < 1) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  int grid = 0;
  const auto query = [&](auto kernel, int* cache) {
    return grid_of(kernel, n, device, cache, &grid);
  };
  err = pushsum ? pushsum_instance(faulted, flags, query)
                : gossip_instance(faulted, flags & (kTele | kDup | kDelay), query);
  return err == cudaSuccess ? grid : -(int)err;
}
