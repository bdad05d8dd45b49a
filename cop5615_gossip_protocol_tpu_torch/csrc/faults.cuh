// Per-node rules of the failure model that the scatter round (csrc/
// scatter.cu), the pool kernels (csrc/fused_pool.cu, csrc/fused_pool2.cu),
// the lattice and imp kernels (csrc/fused_resident.cu, csrc/fused_stencil.cu,
// csrc/fused_imp.cu) and the shard kernels (csrc/fused_imp_hbm_shard.cu,
// csrc/fused_pool2_shard.cu, csrc/fused_stencil_shard.cu,
// csrc/fused_stencil_hbm_shard.cu) share: the drop gate, the alive test of
// the crash and recovery models, the rejoin reset's trigger, the frozen
// state of a dead node, the global-termination residual, absorb and latch (ops/faults.py, ops/sampling.send_gate,
// models/pushsum.absorb_global), and the chunk kernels' fault inputs with
// the mark that folds the gate and the dead in.
//
// Plain inline code usable from the host too, so the CPU tests build it
// with g++ (tests/test_torch_faults.py) and hold it against the plain
// torch versions without a GPU.
#pragma once

#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace gossip {

// fold_in tag of the drop gate (ops/sampling.GATE_TAG), folded into the
// round key: the gate key of a round is the Threefry pair at (0, tag).
constexpr uint32_t kGateTag = 0x5EEDu;

// The gate key of the round whose fold_in key is (r1, r2).
GOSSIP_HD void gate_key(uint32_t r1, uint32_t r2, uint32_t& g1, uint32_t& g2) {
  g1 = 0u;
  g2 = kGateTag;
  threefry2x32(r1, r2, g1, g2);
}

// Whether node j's send passes the round's drop gate: its word at flat
// position j of the gate stream is at least the threshold (a threshold of
// 0 passes every node).
GOSSIP_HD bool gate_open(uint32_t g1, uint32_t g2, uint32_t thresh, int j) {
  return thresh == 0u || threefry_word(g1, g2, (uint32_t)j) >= thresh;
}

// Whether a node with death round `death` is alive during round `round`.
GOSSIP_HD bool alive_in(int death, int round) { return death > round; }

// The same under a recovery model, with revival round `revive`: dead
// exactly during death <= round < revive.
GOSSIP_HD bool alive_in(int death, int revive, int round) {
  return death > round || revive <= round;
}

// Node j's alive test of round `round` from nullable death and revival
// planes (no death plane: alive; no revival plane: crash-stop).
GOSSIP_HD bool node_alive(const int* death, const int* revive, int j,
                          int round) {
  if (death == nullptr) return true;
  return revive == nullptr ? alive_in(death[j], round)
                           : alive_in(death[j], revive[j], round);
}

// Whether node j rejoins in round `round` with a reset of its state: it
// revives then (a revival plane, not null) and the run's rejoin resets a
// revived node (`reset`: gossip always, push-sum under rejoin="fresh").
// Every reader of node j's round-start state in round `round` takes the
// reset value then (models/runner.make_revive_fn: push-sum (s = j, w = 0,
// term = initial, conv = 0), gossip (count 0, inactive, conv 0)), so the
// stored planes keep the un-reset state until that round runs.
GOSSIP_HD bool rejoins(const int* revive, int reset, int j, int round) {
  return reset && revive != nullptr && revive[j] == round;
}

// Node j's round-start push-sum state (s, w, term, conv) where it rejoins
// with a reset (`rn`): (j, 0, the initial term, 0); as it is otherwise.
GOSSIP_HD void rejoin_pushsum(bool rn, int j, int init_term, float& s, float& w,
                              int& term, int& conv) {
  if (rn) {
    s = (float)j;
    w = 0.0f;
    term = init_term;
    conv = 0;
  }
}

// The same for gossip's (count, active, conv): (0, 0, 0).
GOSSIP_HD void rejoin_gossip(bool rn, int& count, int& active, int& conv) {
  if (rn) count = active = conv = 0;
}

// A node's protocol value after a round: the new one if it was alive, the
// old one (frozen) if it was dead.
GOSSIP_HD int frozen(bool alive, int new_value, int old_value) {
  return alive ? new_value : old_value;
}

// Whether a node's ratio moved more than the global rule allows this
// round: |s_new / w_new - s / w| > delta * max(|s / w|, 1). A node that
// received nothing has the same ratio and never counts.
GOSSIP_HD bool unstable_global(float s_t, float w_t, float s_new, float w_new,
                               float delta) {
  const float ratio_old = s_t / w_t;
  const float a = fabsf(ratio_old);
  const float tol = delta * (a > 1.0f ? a : 1.0f);
  return fabsf(s_new / w_new - ratio_old) > tol;
}

// A node's push-sum absorb under global termination (the global instances
// of csrc/fused_stencil.cu, csrc/fused_imp.cu, csrc/fused_imp_hbm_shard.cu):
// its halved send leaves when it sends, the inbox sums arrive, and its term
// and conv stay. Sets s_new and w_new; returns whether it is a real node
// (not a pad lane) whose ratio moved more than the global rule allows.
GOSSIP_HD bool absorb_global(float s_t, float w_t, bool pad, bool sends,
                             float in_s, float in_w, float delta, float& s_new,
                             float& w_new) {
  const float s_send = sends ? s_t * 0.5f : 0.0f;
  const float w_send = sends ? w_t * 0.5f : 0.0f;
  s_new = (s_t - s_send) + in_s;
  w_new = (w_t - w_send) + in_w;
  return !pad && unstable_global(s_t, w_t, s_new, w_new, delta);
}

// Node j's conv flag in a chunk's result under global termination: where
// the chunk's rounds ended in the global verdict (`latch`) 1 on every real
// node (j < n) and 0 on the pad lanes, else its own flag.
GOSSIP_HD int latched_conv(bool latch, int j, int n, int conv) {
  return latch ? (j < n ? 1 : 0) : conv;
}

// XLA's flush, as the plain rounds write it out (models/pushsum.flush): a
// float32 result under FLT_MIN in magnitude becomes a zero of its sign.
// Only a crash drains push-sum mass into that range (the gate keeps the
// mass of a node it blocks, and global termination refuses crashes), and
// only mass_deflate's negated halves can cancel into it, so only the
// push-sum kernels' faulted instances flush; on any other state a flush
// changes nothing.
GOSSIP_HD float flush(float x) {
  return fabsf(x) < 1.17549435e-38f ? copysignf(0.0f, x) : x;
}

// A push-sum node's kept halves under the flush, in the form of the JAX
// package's compiled round (models/pushsum.halve_and_send): the kept w half
// is flush(sends ? w * 0.5 : w), and so is the kept s half with FoldS (pool,
// imp pool and scatter delivery), else (stencil delivery) flush(s - its
// flushed send). Equal to s - s * 0.5 wherever no half is flushed.
template <bool FoldS>
GOSSIP_HD void keep_flushed(float s, float w, bool sends, float& s_keep,
                            float& w_keep) {
  s_keep = FoldS ? flush(sends ? s * 0.5f : s)
                 : flush(s - flush(sends ? s * 0.5f : 0.0f));
  w_keep = flush(sends ? w * 0.5f : w);
}

// Byzantine modes, as the kernels take them (ops/fused.BYZ_MODES): what a
// lying push-sum sender puts on the wire, what a lying gossip node does to
// its own state.
constexpr int kMassInflate = 1;
constexpr int kMassDeflate = 2;
constexpr int kGarble = 3;
constexpr int kStaleRumor = 4;

// Whether node j is an adversary in round `round`: from its onset round on
// (ops/faults.byzantine_at); no plane (null): never.
GOSSIP_HD bool byzantine_in(const int* byz, int j, int round) {
  return byz != nullptr && byz[j] <= round;
}

// A lying push-sum sender's wire pair (models/runner.make_byz_send_fn):
// from its honest flushed halves (s_send, w_send) and its round-start (s, w),
// mass_inflate sends the whole (s, w), mass_deflate the negated halves,
// garble the halves with the channels swapped. Its kept halves stay honest.
GOSSIP_HD void lie_send(int mode, float s, float w, float& s_send,
                        float& w_send) {
  if (mode == kMassInflate) {
    s_send = s;
    w_send = w;
  } else if (mode == kMassDeflate) {
    s_send = -s_send;
    w_send = -w_send;
  } else if (mode == kGarble) {
    const float x = s_send;
    s_send = w_send;
    w_send = x;
  }
}

// A live gossip adversary's state at the end of its round, after the dead
// freeze (models/runner.make_byz_override_fn): stale_rumor pins (count 0,
// active, unconverged), garble latches conv.
GOSSIP_HD void gossip_override(int mode, bool lying, int& count, int& active,
                               int& conv) {
  if (!lying) return;
  if (mode == kStaleRumor) {
    count = 0;
    active = 1;
    conv = 0;
  } else {
    conv = 1;
  }
}

// A chunk's failure model, as the chunk kernels' faulted instances (their
// F = true template argument) take it: the drop gate's threshold (0: no
// gate; each round's gate key is its round key folded with the gate tag,
// gate_key, once a thread a round), each node's death round over the
// padded layout (pad lanes 0; null: no crash model) with each chunk
// round's quorum need, the chunk's first absolute round, global
// termination (push-sum), and under a recovery model each node's revival
// round over the layout (pad lanes never; null: crash-stop), whether a
// revived node resets and push-sum's initial term (csrc/fused_pool.cu and
// csrc/fused_resident.cu carry it; the other kernels' plans refuse it),
// and each node's Byzantine onset round over the layout (pad lanes never;
// null: no adversary) with the mode (csrc/fused_pool.cu and
// csrc/fused_resident.cu carry them; the JAX ladder runs no other fused
// tier with them).
struct Faults {
  uint32_t thresh;
  const int* death;
  const int* needs;
  int start, global;
  const int* revive = nullptr;
  int reset = 0, init_term = 0;
  const int* byz = nullptr;
  int byz_mode = 0;
};

// A sender's mark bit under a recovery model with push-sum's fresh rejoin
// (csrc/fused_pool.cu, csrc/fused_resident.cu, their faulted instances):
// set on the mark of a node that rejoins in the round the mark is for, so
// its receivers take its reset state, (s = its index, w = 0), in place of
// the stored one. Marks are class or slot indices below 16.
constexpr int8_t kRejoinBit = 16;

// A push-sum sender's mark bit under a Byzantine model (the same faulted
// instances): set, by its owner a round ahead as kRejoinBit is, on the mark
// of a node that sends as an adversary in the round the mark is for, so its
// receivers apply the mode to what they read of it (read_send).
constexpr int8_t kLieBit = 32;

// Whether a sender's mark `m` (kRejoinBit and kLieBit maybe set) is class
// or slot k.
GOSSIP_HD bool mark_hit(int8_t m, int k) {
  return (int8_t)(m & ~(kRejoinBit | kLieBit)) == k;
}

// A push-sum sender's mark `m` for absolute round `round` with kLieBit set
// where it sends (m >= 0) as an adversary then.
GOSSIP_HD int8_t lie_mark(int8_t m, const int* byz, int j, int round) {
  return m >= 0 && byzantine_in(byz, j, round) ? (int8_t)(m | kLieBit) : m;
}

// What a receiver reads of a sender whose mark is `m` and whose stored
// round-start state is (s, w): half of the reset state (its index, 0)
// where kRejoinBit is set, else half of (s, w), each half flushed, and the
// pair lied (lie_send under `mode`) where kLieBit is set.
GOSSIP_HD void read_send(int8_t m, int i, float s, float w, int mode,
                         float& s_send, float& w_send) {
  const bool rn = m >= 0 && (m & kRejoinBit);
  const float si = rn ? (float)i : s, wi = rn ? 0.0f : w;
  s_send = flush(si * 0.5f);
  w_send = flush(wi * 0.5f);
  if (m >= 0 && (m & kLieBit)) lie_send(mode, si, wi, s_send, w_send);
}

// Node j's mark for chunk round k (absolute round f.start + k) under F:
// its mark, or -1 when the round's gate (key (g1, g2)) blocks it or it is
// dead then. F = false returns the mark as it is.
template <bool F>
GOSSIP_HD int8_t faulted_mark(int8_t mark, const Faults& f, int k, uint32_t g1,
                              uint32_t g2, int j) {
  if (!F || mark < 0) return mark;
  if (!node_alive(f.death, f.revive, j, f.start + k)) return (int8_t)-1;
  if (!gate_open(g1, g2, f.thresh, j)) return (int8_t)-1;
  return mark;
}

// Node j's mark for chunk round k in a faulted instance that carries
// crash-recovery: -1 if it is not active (gossip's flag; push-sum passes
// true), else its mark less the gate and the dead (faulted_mark). A node
// that rejoins in round k with a reset starts it inactive, so a gossip
// node's (`gossip_node`) mark is -1, and a push-sum node's carries
// kRejoinBit.
GOSSIP_HD int8_t rejoin_mark(int8_t mark, bool active, bool gossip_node,
                             const Faults& f, int k, uint32_t g1, uint32_t g2,
                             int j) {
  const bool rn = rejoins(f.revive, f.reset, j, f.start + k);
  if (!active || (gossip_node && rn)) return (int8_t)-1;
  const int8_t m = faulted_mark<true>(mark, f, k, g1, g2, j);
  return m >= 0 && rn ? (int8_t)(m | kRejoinBit) : m;
}

// The gate key of the round whose fold_in key is (k0, k1), under F with a
// gate; (0, 0) otherwise (unused then).
template <bool F>
GOSSIP_HD void round_gate_key(const Faults& f, uint32_t k0, uint32_t k1,
                              uint32_t& g1, uint32_t& g2) {
  g1 = g2 = 0u;
  if (F && f.thresh != 0u) gate_key(k0, k1, g1, g2);
}

// Whether node j sends in chunk round k (absolute round f.start + k) under
// F: a real node (j < n) that is active (gossip's flag; push-sum passes
// true), alive then and whose gate word (key (g1, g2)) passes. Branch-free
// over its tests, so a thread's nodes issue their gate hashes together.
GOSSIP_HD bool send_flag(const Faults& f, bool active, int j, int n, int k,
                         uint32_t g1, uint32_t g2) {
  const bool alive = node_alive(f.death, f.revive, j, f.start + k);
  return active & (j < n) & alive & gate_open(g1, g2, f.thresh, j);
}

}  // namespace gossip
