// Per-node logic of the imp kernels in csrc/fused_imp.cu: the class an
// imp2d/imp3d node sends along this round under pooled long-range
// sampling, and the packed choice word its pool slot comes from. The
// device-side counterpart of ops/fused_imp.py's _imp_classes.
//
// Plain inline code usable from the host too, so g++ builds it for the CPU
// tests (tests/test_torch_fused_imp.py), which hold it against the JAX
// package's imp sampling without a GPU.
#pragma once

#include <stdint.h>

#include "stencil.cuh"
#include "threefry.cuh"

namespace gossip {

// Nodes (rows of the [rows, 128] layout) per packed choice word.
constexpr int kChoicePack = 8;
constexpr int kChoiceLanes = 128;

// Counter of the packed choice word that holds node j's pool slot: the
// word of j's lane in its group of 8 rows (sampling.pool_choice_packed).
GOSSIP_HD uint32_t choice_counter(int j) {
  return (uint32_t)((j / (kChoicePack * kChoiceLanes)) * kChoiceLanes +
                    j % kChoiceLanes);
}

// Node j's nibble in that word.
GOSSIP_HD int choice_sub(int j) { return (j / kChoiceLanes) % kChoicePack; }

// Class id real node j (< L.n) sends along, from its slot word `bits` and
// its pool slot `choice`: slot = bits % degree over its live lattice
// directions and, last, its long-range slot (live on every real node); a
// lattice slot gives the index of its displacement in the sorted lattice
// classes (so at grid side 2, where two directions share a displacement,
// they share a class), the long-range slot class lattice.count + choice.
GOSSIP_HD int imp_class(const Lattice& L, const Classes& lattice, int j,
                        uint32_t bits, int choice) {
  bool live[kMaxDirs];
  int disp[kMaxDirs];
  const int dirs = lattice_dirs(L, j, live, disp);
  int deg = 1;  // the long-range slot
  for (int k = 0; k < dirs; ++k) deg += live[k] ? 1 : 0;
  const int slot = (int)(bits % (uint32_t)deg);
  int cum = 0;
  for (int k = 0; k < dirs; ++k) {
    if (live[k]) {
      if (cum == slot) return class_of(disp[k], lattice.d, lattice.count);
      ++cum;
    }
  }
  return lattice.count + choice;
}

}  // namespace gossip
