// Per-node logic of the imp kernels in csrc/fused_imp.cu and
// csrc/fused_imp_hbm_shard.cu: the class an imp2d/imp3d node sends along
// this round under pooled long-range sampling, the packed choice word its
// pool slot comes from, the nodes a sharded mark launch covers, and each
// receiver's inbox over the lattice and pool classes. The device-side
// counterpart of ops/fused_imp.py's imp_marks and of the absorbs of
// parallel/fused_imp_hbm_sharded.py.
//
// Plain inline code usable from the host too, so g++ builds it for the CPU
// tests (tests/test_torch_fused_imp.py, tests/test_torch_imp_shard_host.py),
// which hold it against the JAX package's imp sampling and the port's plain
// versions without a GPU.
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

// The packed choice words whose 8-row group meets rows [row_lo, row_hi):
// word indices [first_word(row_lo), end_word(row_hi)).
GOSSIP_HD int first_word(int row_lo) { return (row_lo / kChoicePack) * kChoiceLanes; }
GOSSIP_HD int end_word(int row_hi) {
  return ((row_hi + kChoicePack - 1) / kChoicePack) * kChoiceLanes;
}

// The node that sub-row `sub` of choice word `wi` holds, and its row.
GOSSIP_HD int word_row(int wi, int sub) { return (wi / kChoiceLanes) * kChoicePack + sub; }
GOSSIP_HD int word_node(int wi, int sub) {
  return word_row(wi, sub) * kChoiceLanes + wi % kChoiceLanes;
}

// The round's pool displacements, passed by value.
constexpr int kMaxImpPool = 16;  // the packed-choice limit: 4 bits a node

struct ImpPool {
  int count;
  int d[kMaxImpPool];
};

// Receiver j's push-sum inbox (j real): from 0.0, over the lattice classes
// q in sorted order and then the pool slots p, the halved send of the class
// source (class_source: j - d mod n) whose mark is the class id (q, or
// lattice.count + p). Unrolled to the caps, so the class lists stay in
// registers and every class's mark load is in flight at once.
GOSSIP_HD void imp_pushsum_inbox(const Classes& lattice, const ImpPool& pool,
                                 const int8_t* mark, const float* s,
                                 const float* w, int j, int n, float& in_s,
                                 float& in_w) {
  in_s = 0.0f;
  in_w = 0.0f;
#pragma unroll
  for (int c = 0; c < kMaxDirs + kMaxImpPool; ++c) {
    const bool lat = c < kMaxDirs;
    const int k = lat ? c : c - kMaxDirs;
    if (lat ? k < lattice.count : k < pool.count) {
      const int i = class_source(j, lat ? lattice.d[k] : pool.d[k], n);
      float vs = 0.0f, vw = 0.0f;
      if (mark[i] == (lat ? k : lattice.count + k)) {
        vs = s[i] * 0.5f;
        vw = w[i] * 0.5f;
      }
      in_s = in_s + vs;
      in_w = in_w + vw;
    }
  }
}

// Receiver j's gossip inbox (j real): the class sources whose mark is the
// class id, over the same classes.
GOSSIP_HD int imp_gossip_inbox(const Classes& lattice, const ImpPool& pool,
                               const int8_t* mark, int j, int n) {
  int inbox = 0;
#pragma unroll
  for (int c = 0; c < kMaxDirs + kMaxImpPool; ++c) {
    const bool lat = c < kMaxDirs;
    const int k = lat ? c : c - kMaxDirs;
    if (lat ? k < lattice.count : k < pool.count)
      inbox += mark[class_source(j, lat ? lattice.d[k] : pool.d[k], n)] ==
                       (lat ? k : lattice.count + k)
                   ? 1
                   : 0;
  }
  return inbox;
}

}  // namespace gossip
