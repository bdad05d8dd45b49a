// Per-node logic of the lattice (stencil) kernels in csrc/fused_stencil.cu
// and csrc/fused_resident.cu: the direction pairs of the six arithmetic
// lattices in neighbour-column order, the sampled displacement, each
// sender's class mark and each receiver's class check, and the resident
// kernel's per-round barrier word. The device-side counterpart of
// ops/topology.py's lattice_dirs and ops/fused_stencil_hbm.py's
// _sample_disp_dirs. The lattice kernels mark from the host-built
// directions word (csrc/shard.cuh word_mark), which the tests hold against
// mark_of here; csrc/imp.cuh marks through mark_of itself.
//
// Plain inline code usable from the host too, so g++ builds it for the CPU
// tests (tests/test_torch_stencil.py, tests/test_torch_lattice_dir_words.py)
// and they hold it against the JAX package's topologies and sampling and
// the chunked engine's sums without a GPU.
#pragma once

#include <math.h>
#include <stdint.h>

#include "faults.cuh"
#include "threefry.cuh"

namespace gossip {

// Lattice families; ref2d is wired as a line (quirk Q6) and uses kLine.
enum LatticeKind : int {
  kRing = 0,
  kLine = 1,
  kGrid2d = 2,
  kGrid3d = 3,
  kTorus3d = 4,
};

constexpr int kMaxDirs = 6;
constexpr int kMaxClasses = 16;

// The sorted displacement classes a chunk delivers along, passed by value.
struct Classes {
  int count;
  int d[kMaxClasses];
};

struct Lattice {
  int kind;
  int n;      // population
  int n_lat;  // lattice nodes: n, or n - 1 past the reference's unwired node
  int side;   // grid2d side, or the 3-D cube side g; 0 for the chains
};

GOSSIP_HD long long power(long long v, int p) {
  return p == 2 ? v * v : v * v * v;
}

// Largest r with r**p <= x (p = 2 or 3), by integer steps from a float
// guess: exact for every x < 2**31.
GOSSIP_HD int integer_root(int x, int p) {
  long long r = (long long)(p == 2 ? sqrt((double)x) : cbrt((double)x));
  while (r > 0 && power(r, p) > x) --r;
  while (power(r + 1, p) <= x) ++r;
  return (int)r;
}

// The lattice of a population-n topology of `kind`. `extra_node` is 1 when
// the last node is the reference's unwired Q1 node (degree 0, past the
// lattice: the grids in reference semantics), else 0.
GOSSIP_HD Lattice make_lattice(int kind, int n, int extra_node) {
  Lattice L;
  L.kind = kind;
  L.n = n;
  L.n_lat = n - extra_node;
  L.side = kind == kGrid2d ? integer_root(L.n_lat, 2)
           : (kind == kGrid3d || kind == kTorus3d) ? integer_root(L.n_lat, 3)
                                                    : 0;
  return L;
}

// Direction pairs of node j in the topology's neighbour-column order: the
// k-th pair is (live[k], disp[k]) with disp the mod-n displacement of that
// edge. The j-th LIVE pair is column j of the topology's neighbour table.
// Returns the number of pairs. Wrap lattices have every pair live; the
// others mask boundary faces and every node at or past n_lat.
GOSSIP_HD int lattice_dirs(const Lattice& L, int j, bool* live, int* disp) {
  const int n = L.n;
  const bool in = j < L.n_lat;
  switch (L.kind) {
    case kRing:
      live[0] = live[1] = true;
      disp[0] = n - 1;
      disp[1] = 1;
      return 2;
    case kLine:
      live[0] = in && j > 0;
      disp[0] = n - 1;
      live[1] = in && j < L.n_lat - 1;
      disp[1] = 1;
      return 2;
    case kGrid2d: {
      const int s = L.side, x = j % s, y = j / s;
      live[0] = in && x > 0;      disp[0] = n - 1;
      live[1] = in && x < s - 1;  disp[1] = 1;
      live[2] = in && y > 0;      disp[2] = n - s;
      live[3] = in && y < s - 1;  disp[3] = s;
      return 4;
    }
    case kGrid3d: {
      const int g = L.side, g2 = g * g;
      const int x = j % g, y = (j / g) % g, z = j / g2;
      live[0] = in && x > 0;      disp[0] = n - 1;
      live[1] = in && x < g - 1;  disp[1] = 1;
      live[2] = in && y > 0;      disp[2] = n - g;
      live[3] = in && y < g - 1;  disp[3] = g;
      live[4] = in && z > 0;      disp[4] = n - g2;
      live[5] = in && z < g - 1;  disp[5] = g2;
      return 6;
    }
    default: {  // kTorus3d: the wrap edge of a face is +-(g-1) steps away
      const int g = L.side, g2 = g * g;
      const int x = j % g, y = (j / g) % g, z = j / g2;
      for (int k = 0; k < 6; ++k) live[k] = true;
      disp[0] = x > 0 ? n - 1 : g - 1;
      disp[1] = x < g - 1 ? 1 : n - (g - 1);
      disp[2] = y > 0 ? n - g : g * (g - 1);
      disp[3] = y < g - 1 ? g : n - g * (g - 1);
      disp[4] = z > 0 ? n - g2 : g2 * (g - 1);
      disp[5] = z < g - 1 ? g2 : n - g2 * (g - 1);
      return 6;
    }
  }
}

// Sampled mod-n displacement of node j from its word `bits`, as
// sampling.targets_explicit draws it: slot = bits % degree (unsigned), then
// the slot-th live pair in column order. -1 for a degree-0 node, which
// never sends.
GOSSIP_HD int sample_disp(const Lattice& L, int j, uint32_t bits) {
  bool live[kMaxDirs];
  int disp[kMaxDirs];
  const int dirs = lattice_dirs(L, j, live, disp);
  int deg = 0;
  for (int k = 0; k < dirs; ++k) deg += live[k] ? 1 : 0;
  if (deg == 0) return -1;
  const int slot = (int)(bits % (uint32_t)deg);
  int d = -1, cum = 0;
  for (int k = 0; k < dirs; ++k) {
    if (live[k]) {
      if (cum == slot) d = disp[k];
      ++cum;
    }
  }
  return d;
}

// Index of displacement d in the sorted class list, or -1 (also for d < 0).
// At torus cube side 2 two directions share one displacement, hence one
// class: the check is on the displacement, never on the direction.
GOSSIP_HD int class_of(int d, const int* classes, int count) {
  int index = -1;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c)
    if (c < count && classes[c] == d) index = c;
  return index;
}

// The node whose message along class displacement d lands on receiver j
// (the mod-n roll by d); j receives it iff that node's mark is the class.
GOSSIP_HD int class_source(int j, int d, int n) {
  return j >= d ? j - d : j - d + n;
}

// Class index of node j's sampled displacement this round under the
// round's key (two uint32 words), -1 for none.
GOSSIP_HD int8_t mark_of(const Lattice& L, const Classes& cls,
                         const long long* key, int j) {
  const uint32_t word = threefry_word((uint32_t)key[0], (uint32_t)key[1],
                                      (uint32_t)j);
  const int d = sample_disp(L, j, word);
  return (int8_t)(d < 0 ? -1 : class_of(d, cls.d, cls.count));
}

// Receiver j's push-sum inbox: over the classes in ascending order, from
// 0.0, the halved send of each class source whose mark is that class (the
// chunked engine's float32 op order). Unrolled to the class cap so the
// class list stays in registers, and every source's s and w are loaded
// whatever its mark, so they are in flight with the mark loads instead of
// waiting on them (the round's latency chain is one L2 trip shorter).
GOSSIP_HD void pushsum_inbox(const Classes& cls, const int8_t* mark,
                             const float* s, const float* w, int j, int n,
                             float& in_s, float& in_w) {
  in_s = 0.0f;
  in_w = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k) {
    if (k < cls.count) {
      const int i = class_source(j, cls.d[k], n);
      const float si = s[i], wi = w[i];
      const bool hit = mark[i] == k;
      in_s = in_s + (hit ? si * 0.5f : 0.0f);
      in_w = in_w + (hit ? wi * 0.5f : 0.0f);
    }
  }
}

// pushsum_inbox in the faulted instances, where the marks may carry
// kRejoinBit and kLieBit (csrc/faults.cuh): a source whose mark is the
// class sends what read_send gives (half of (its index, 0) where it
// rejoins, the Byzantine `mode`'s pair where it lies), and every half and
// every add is flushed, as the plain round flushes them.
GOSSIP_HD void pushsum_inbox_rejoin(const Classes& cls, const int8_t* mark,
                                    const float* s, const float* w, int j,
                                    int n, float& in_s, float& in_w,
                                    int mode = 0) {
  in_s = 0.0f;
  in_w = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k) {
    if (k < cls.count) {
      const int i = class_source(j, cls.d[k], n);
      const int8_t m = mark[i];
      float hs, hw;
      read_send(m, i, s[i], w[i], mode, hs, hw);
      const bool hit = mark_hit(m, k);
      in_s = flush(in_s + (hit ? hs : 0.0f));
      in_w = flush(in_w + (hit ? hw : 0.0f));
    }
  }
}

// Receiver j's gossip inbox: the class sources whose mark is the class.
GOSSIP_HD int gossip_inbox(const Classes& cls, const int8_t* mark, int j,
                           int n) {
  int inbox = 0;
#pragma unroll
  for (int k = 0; k < kMaxClasses; ++k)
    if (k < cls.count) inbox += mark[class_source(j, cls.d[k], n)] == k ? 1 : 0;
  return inbox;
}

// The per-round barrier word of csrc/fused_resident.cu: each block adds
// its arrival (the high 32 bits) and its converged count (the low 32 bits)
// in one 64-bit atomic. A grid's counts sum to at most n_pad < 2**31, so
// the low half never carries into the arrivals.
GOSSIP_HD unsigned long long barrier_arrival(int count) {
  return (1ull << 32) | (uint32_t)count;
}

GOSSIP_HD uint32_t barrier_arrivals(unsigned long long word) {
  return (uint32_t)(word >> 32);
}

GOSSIP_HD int barrier_total(unsigned long long word) {
  return (int)(uint32_t)word;
}

// Lattice and class list of a chunk from its C arguments (host side);
// false if they are out of range for the kernels.
inline bool setup_lattice(int kind, int n, int extra_node, const int* classes,
                          int n_classes, Lattice* L, Classes* cls) {
  if (kind < kRing || kind > kTorus3d || n < 2 || n_classes < 1 ||
      n_classes > kMaxClasses || (extra_node != 0 && extra_node != 1))
    return false;
  *L = make_lattice(kind, n, extra_node);
  cls->count = n_classes;
  for (int k = 0; k < kMaxClasses; ++k)
    cls->d[k] = k < n_classes ? classes[k] : 0;
  for (int k = 0; k < n_classes; ++k)
    if (cls->d[k] < 1 || cls->d[k] >= n) return false;
  return true;
}

}  // namespace gossip
