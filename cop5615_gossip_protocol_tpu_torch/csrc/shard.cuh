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
// further away in the buffer). Slots near the buffer's ends read garbage
// that rolled in from the far end; it advances at most one halo width a
// round, and H covers a super-step's rounds, so the middle stays exact.
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
  int row0;      // global row of extended row 0, in [0, R)
  int rows_ext;  // rows_loc + 2 * H
  int H;         // halo rows on each side
  int rows_loc;  // the shard's own rows
};

// The classes of a shard's delivery: the sorted mod-n displacements (the
// class ids marks carry) and each class's two roll amounts in [0, n_ext).
struct ShardClasses {
  Classes cls;
  int e1[kMaxClasses];
  int e2[kMaxClasses];
};

// Global row of extended row r (0 <= r < rows_ext).
GOSSIP_HD int shard_global_row(const ShardGeom& G, int r) {
  return (G.row0 + r) % G.R;
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

// Shard geometry and classes from a super-step's C arguments (host side);
// false if they are out of range for the kernels.
inline bool setup_shard(int R, int row0, int rows_ext, int H, int rows_loc,
                        const int* e1, const int* e2, const Classes& cls,
                        ShardGeom* G, ShardClasses* sc) {
  if (R < 1 || row0 < 0 || row0 >= R || H < 1 || rows_loc < 1 ||
      rows_ext != rows_loc + 2 * H || (long long)rows_ext * 128 >= (1LL << 31))
    return false;
  *G = ShardGeom{R, row0, rows_ext, H, rows_loc};
  sc->cls = cls;
  const int n_ext = rows_ext * 128;
  for (int k = 0; k < kMaxClasses; ++k) {
    sc->e1[k] = k < cls.count ? e1[k] : 0;
    sc->e2[k] = k < cls.count ? e2[k] : 0;
    if (sc->e1[k] < 0 || sc->e1[k] >= n_ext || sc->e2[k] < 0 ||
        sc->e2[k] >= n_ext)
      return false;
  }
  return true;
}

}  // namespace gossip
