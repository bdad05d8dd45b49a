// Per-node rules of the failure model that the scatter round (csrc/
// scatter.cu) and the pool kernels (csrc/fused_pool.cu) share: the drop
// gate, the alive test of the crash model, the frozen state of a dead
// node and the global-termination residual (ops/faults.py,
// ops/sampling.send_gate, models/pushsum.absorb_global).
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

}  // namespace gossip
