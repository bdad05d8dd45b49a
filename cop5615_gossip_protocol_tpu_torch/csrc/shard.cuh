// Per-element logic of the sharded lattice kernels in
// csrc/fused_stencil_shard.cu and csrc/fused_stencil_hbm_shard.cu.
//
// A shard owns global rows [i * rows_loc, (i + 1) * rows_loc) of the padded
// [R, 128] pool layout and runs its rounds on a halo-extended buffer of
// rows_ext = rows_loc + 2H rows: its left neighbour's last H rows, its own
// rows_loc rows (the middle), its right neighbour's first H rows. Extended
// row r holds global row (row0 + r) mod R, so every slot has a global flat
// index and draws the bits the single-device engines draw there.
//
// Delivery is a circular roll over the extended buffer: the source of slot
// x along class d is slot x - e (mod n_ext), with e the first roll e1 when
// the receiver's global flat index is at least d and the second e2 below it
// (the mod-n blend: an edge that crosses the global wrap sits the pad Z
// further away in the buffer).
//
// The window contract. Round j of a super-step of `ex` rounds computes only
// the extended rows W_j = [lo, hi) the middle still depends on: W_{ex-1} is
// the middle, W_{j-1} the smallest row range holding W_j and every source
// slot of a non-pad receiver in W_j, and W_{-1} the rows round 0 reads
// (parallel/fused_sharded.shard_windows computes them on the host). Round
// j's absorb writes exactly the rows of W_j of its destination set and, for
// round j + 1, the marks of the same slots; a prologue writes round 0's
// marks over W_{-1}. No source wraps across the buffer's ends (the plan's H
// covers a super-step's shifts; the host refuses windows that would), so
// every value a round writes is the single-device engine's at that global
// index, and rows outside the windows are neither read nor written.
//
// Plain inline code usable from the host too, so g++ builds it for the CPU
// tests (tests/test_torch_stencil_shard_host.py).
#pragma once

#include <stdint.h>

#include "stencil.cuh"
#include "threefry.cuh"

namespace gossip {

// One shard's extended buffer, passed by value.
struct ShardGeom {
  int R;         // rows of the global layout
  int row0;      // global row of extended row 0, in [0, R), row0 + rows_ext <= 2R
  int rows_ext;  // rows_loc + 2 * H
  int H;         // halo rows on each side
  int rows_loc;  // the shard's own rows
};

// A super-step's windows, passed by value: lo[j + 1], hi[j + 1] bound
// W_j in extended rows, lo[0], hi[0] bound W_{-1}.
constexpr int kMaxWindows = 65;  // CR <= 64 rounds, plus W_{-1}
struct ShardWindows {
  int lo[kMaxWindows];
  int hi[kMaxWindows];
};

// The classes of a shard's delivery: the sorted mod-n displacements (the
// class ids marks carry) and each class's two roll amounts in [0, n_ext).
struct ShardClasses {
  Classes cls;
  int e1[kMaxClasses];
  int e2[kMaxClasses];
};

// Global row of extended row r (0 <= r < rows_ext): row0 + r < 2R, so one
// conditional subtract wraps it.
GOSSIP_HD int shard_global_row(const ShardGeom& G, int r) {
  const int row = G.row0 + r;
  return row < G.R ? row : row - G.R;
}

// Global padded flat index of extended slot x.
GOSSIP_HD int shard_global_flat(const ShardGeom& G, int x) {
  return shard_global_row(G, x >> 7) * 128 + (x & 127);
}

// The extended slot whose send along class k reaches slot x, whose global
// flat index is g: the roll by e1 at g >= d, by e2 below it.
GOSSIP_HD int shard_source(const ShardClasses& sc, int k, int x, int g,
                           int n_ext) {
  const int e = g >= sc.cls.d[k] ? sc.e1[k] : sc.e2[k];
  return x >= e ? x - e : x - e + n_ext;
}

// True for the shard's own rows, [H, H + rows_loc): the only rows its
// converged count covers (the halo rows are their home shard's).
GOSSIP_HD bool shard_middle(const ShardGeom& G, int x) {
  const int r = x >> 7;
  return r >= G.H && r < G.H + G.rows_loc;
}

// The class id that a node with static directions word `word` sends along
// when it draws `bits`: bits % degree picks the slot-th live direction, as
// sample_disp and class_of do (csrc/stencil.cuh); -1 for degree 0. The word
// (built once per lattice on the host, parallel/fused_sharded.dir_words)
// holds in bits 4k..4k+3 the class id of the node's k-th live direction in
// the topology's column order and its degree in bits 24..26; it is 0 for a
// degree-0 node and a pad lane.
GOSSIP_HD int word_class(uint32_t word, uint32_t bits) {
  const uint32_t deg = word >> 24;
  return deg == 0 ? -1 : (int)((word >> (4u * (bits % deg))) & 15u);
}

// Round mark of the node at global flat index g: the class it sends along
// under the round key (k0, k1), -1 for none. Nodes that never send skip the
// hash.
GOSSIP_HD int8_t word_mark(uint32_t word, uint32_t k0, uint32_t k1, int g) {
  if (word == 0u) return (int8_t)-1;
  return (int8_t)word_class(word, threefry_word(k0, k1, (uint32_t)g));
}

// Receiver x's push-sum inbox: over the classes in ascending order, from
// 0.0, the halved send of each class source whose mark is that class (the
// chunked engine's float32 op order).
GOSSIP_HD void shard_pushsum_inbox(const ShardClasses& sc, const int8_t* mark,
                                   const float* s, const float* w, int x,
                                   int g, int n_ext, float& in_s,
                                   float& in_w) {
  in_s = 0.0f;
  in_w = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k) {
    if (k < sc.cls.count) {
      const int i = shard_source(sc, k, x, g, n_ext);
      float vs = 0.0f, vw = 0.0f;
      if (mark[i] == k) {
        vs = s[i] * 0.5f;
        vw = w[i] * 0.5f;
      }
      in_s = in_s + vs;
      in_w = in_w + vw;
    }
  }
}

// Receiver x's gossip inbox: the class sources whose mark is the class.
GOSSIP_HD int shard_gossip_inbox(const ShardClasses& sc, const int8_t* mark,
                                 int x, int g, int n_ext) {
  int inbox = 0;
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k)
    if (k < sc.cls.count)
      inbox += mark[shard_source(sc, k, x, g, n_ext)] == k ? 1 : 0;
  return inbox;
}

// Shard geometry, classes and windows from a super-step's C arguments
// (host side); false if they are out of range for the kernels: the class
// list, the rolls, a row map past one wrap, or windows that are not nested
// ranges of the buffer ending at the middle.
inline bool setup_shard(int n, const int* classes, int n_classes, int R,
                        int row0, int rows_ext, int H, int rows_loc,
                        const int* e1, const int* e2, const int* win,
                        int rounds, ShardGeom* G, ShardClasses* sc,
                        ShardWindows* W) {
  if (n < 2 || n_classes < 1 || n_classes > kMaxClasses || R < 1 ||
      row0 < 0 || row0 >= R || H < 1 || rows_loc < 1 ||
      rows_ext != rows_loc + 2 * H || row0 + rows_ext > 2 * R ||
      (long long)R * 128 >= (1LL << 31) ||
      (long long)rows_ext * 128 >= (1LL << 31) || rounds < 1 ||
      rounds >= kMaxWindows)
    return false;
  *G = ShardGeom{R, row0, rows_ext, H, rows_loc};
  const int n_ext = rows_ext * 128;
  sc->cls.count = n_classes;
  for (int k = 0; k < kMaxClasses; ++k) {
    sc->cls.d[k] = k < n_classes ? classes[k] : 0;
    sc->e1[k] = k < n_classes ? e1[k] : 0;
    sc->e2[k] = k < n_classes ? e2[k] : 0;
    if ((k < n_classes && (sc->cls.d[k] < 1 || sc->cls.d[k] >= n)) ||
        sc->e1[k] < 0 || sc->e1[k] >= n_ext || sc->e2[k] < 0 ||
        sc->e2[k] >= n_ext)
      return false;
  }
  for (int j = 0; j < kMaxWindows; ++j) {
    W->lo[j] = j <= rounds ? win[2 * j] : 0;
    W->hi[j] = j <= rounds ? win[2 * j + 1] : 0;
  }
  if (W->lo[rounds] != H || W->hi[rounds] != H + rows_loc) return false;
  for (int j = 0; j < rounds; ++j)
    if (W->lo[j] < 0 || W->lo[j] > W->lo[j + 1] || W->hi[j] < W->hi[j + 1] ||
        W->hi[j] > rows_ext)
      return false;
  return true;
}

}  // namespace gossip
