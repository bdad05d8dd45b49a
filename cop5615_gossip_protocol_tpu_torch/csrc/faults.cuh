// Per-node rules of the failure model that the scatter round (csrc/
// scatter.cu), the pool kernels (csrc/fused_pool.cu, csrc/fused_pool2.cu),
// the lattice and imp kernels (csrc/fused_resident.cu, csrc/fused_stencil.cu,
// csrc/fused_imp.cu) and the shard kernels (csrc/fused_imp_hbm_shard.cu,
// csrc/fused_pool2_shard.cu) share: the drop gate, the alive test of the
// crash model, the frozen state of a dead node, the global-termination
// residual, absorb and latch (ops/faults.py, ops/sampling.send_gate,
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

// A chunk's failure model, as the chunk kernels' faulted instances (their
// F = true template argument) take it: the drop gate's threshold (0: no
// gate; each round's gate key is its round key folded with the gate tag,
// gate_key, once a thread a round), each node's death round over the
// padded layout (pad lanes 0; null: no crash model) with each chunk
// round's quorum need, the chunk's first absolute round, and global
// termination (push-sum).
struct Faults {
  uint32_t thresh;
  const int* death;
  const int* needs;
  int start, global;
};

// Node j's mark for chunk round k (absolute round f.start + k) under F:
// its mark, or -1 when the round's gate (key (g1, g2)) blocks it or it is
// dead then. F = false returns the mark as it is.
template <bool F>
GOSSIP_HD int8_t faulted_mark(int8_t mark, const Faults& f, int k, uint32_t g1,
                              uint32_t g2, int j) {
  if (!F || mark < 0) return mark;
  if (f.death != nullptr && !alive_in(f.death[j], f.start + k)) return (int8_t)-1;
  if (!gate_open(g1, g2, f.thresh, j)) return (int8_t)-1;
  return mark;
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
  const bool alive = f.death == nullptr || alive_in(f.death[j], f.start + k);
  return active & (j < n) & alive & gate_open(g1, g2, f.thresh, j);
}

}  // namespace gossip
