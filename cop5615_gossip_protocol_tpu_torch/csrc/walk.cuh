// The reference-semantics push-sum walk (csrc/walk.cu): the hop's random
// word, the neighbour pick and the node's update, the JAX package's
// models/reference.py step_fn in float32, and the walker's loop over a
// block of prepared hop entries.
//
// Like threefry.cuh, everything here is plain inline code usable from the
// host, so the CPU tests build it with g++ and hold it against the JAX
// step function and run_walk without a GPU.
#pragma once

#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace gossip {
namespace walk {

// The walk's scalars: the node about to process the in-flight message,
// hops taken, the Q8 dead latch, the converged count, the message.
struct Carry {
  int cur;
  int steps;
  int dead;
  int conv_count;
  float msg_s;
  float msg_w;
};

// The word of hop `step`: jax.random.bits(fold_in(base, step), ()) — the
// fold_in hashes the counter pair (0, step) under the base key, and the
// scalar draw hashes (0, 0) under that key.
GOSSIP_HD uint32_t hop_word(uint32_t k1, uint32_t k2, uint32_t step) {
  uint32_t a = 0u, b = step;
  threefry2x32(k1, k2, a, b);
  return threefry_word(a, b, 0u);
}

// ---------------------------------------------------------------------------
// Picks without a division on the walker's path
// ---------------------------------------------------------------------------

// The shift of the full pick, 1 + word % (n - 1) in [1, n), which depends
// on the word alone, so the kernel's other threads compute it ahead of the
// walker (0 when n < 2: there is no other node).
GOSSIP_HD uint32_t full_shift(uint32_t word, int n) {
  return n < 2 ? 0u : 1u + word % (uint32_t)(n - 1);
}

// On full the partner is (node + shift) mod n; node < n and shift < n, so
// the modulo is the unsigned minimum of x and x - n (which wraps past x
// when x < n). n < 2 has no other node: 0.
struct FullPick {
  int n;
  GOSSIP_HD int next(uint32_t shift, int node, bool& ok) const {
    ok = true;
    if (n < 2) return 0;
    const uint32_t x = (uint32_t)node + shift, y = x - (uint32_t)n;
    return (int)(y < x ? y : x);
  }
  // The node whose planes the walk reads after the pick: the pick itself.
  GOSSIP_HD int real(int picked, int) const { return picked; }
};

// Lemire's fastmod (Lemire, Kaser, Kurz, "Faster remainder by direct
// computation", 2019): with M = ceil(2**64 / d), a % d is the high 64 bits
// of (M * a mod 2**64) * d, exact for every 32-bit a and every d in
// [1, 2**32). M is 0 for d = 1 (and for d = 0, whose pick is column 0 as
// word % max(d, 1) gives).
GOSSIP_HD uint64_t fastmod_constant(uint32_t d) {
  return d < 2 ? 0ull : ~0ull / d + 1ull;
}

GOSSIP_HD uint32_t fastmod(uint32_t a, uint64_t m, uint32_t d) {
  const uint64_t low = m * a;
#ifdef __CUDA_ARCH__
  return (uint32_t)__umul64hi(low, (uint64_t)d);
#else
  return (uint32_t)(((unsigned __int128)low * d) >> 64);
#endif
}

// A node's staged row on an explicit topology: its fastmod constant (low
// word, high word), its degree, then its padded neighbour columns, so the
// row's first three words come in with one address and the column with
// one more.
GOSSIP_HD int row_stride(int max_deg) { return max_deg + 3; }

GOSSIP_HD void stage_row(int* rows, int i, const int* nbr, const int* deg,
                         int max_deg) {
  int* row = rows + (long long)i * row_stride(max_deg);
  const int d = deg[i];
  const uint64_t m = fastmod_constant((uint32_t)d);
  row[0] = (int)(uint32_t)m;
  row[1] = (int)(uint32_t)(m >> 32);
  row[2] = d;
  for (int k = 0; k < max_deg; ++k) row[3 + k] = nbr[(long long)i * max_deg + k];
}

// A dead walk's pick (an orphan's padded column 0) may be any value: the
// walk reads a real node in its place.
GOSSIP_HD int real_node(int picked, int node, int n) {
  return (unsigned)picked < (unsigned)n ? picked : node;
}

struct RowPick {
  const int* rows;
  int stride;
  int n;
  GOSSIP_HD int next(uint32_t word, int node, bool& ok) const {
    const int* row = rows + (long long)node * stride;
    const uint64_t m = (uint64_t)(uint32_t)row[0] | ((uint64_t)(uint32_t)row[1] << 32);
    const int d = row[2];
    ok = d > 0;
    return row[3 + fastmod(word, m, (uint32_t)d)];
  }
  GOSSIP_HD int real(int picked, int node) const { return real_node(picked, node, n); }
};

// ---------------------------------------------------------------------------
// The node's update and the walker's loop
// ---------------------------------------------------------------------------

// One node as the walker keeps it, a 16-byte record, so a node is one
// load and one store: s, w, its ratio s / w, and termRound and conv as
// term * 2 + conv. A hop needs the node's ratio before and after; keeping
// the one after in the record makes the next visit's "before" a load, not
// a division. It is the hop's own newsum / newweight whenever halving both
// was exact, the real quotient being the same.
struct alignas(16) Node {
  float s;
  float w;
  float ratio;
  int tc;
};

GOSSIP_HD Node make_node(float s, float w, int term, int conv) {
  return Node{s, w, s / w, term * 2 + conv};
}

// The walker's nodes: its records, in shared memory or in scratch.
struct Records {
  Node* p;
  GOSSIP_HD Node load(int i) const { return p[i]; }
  GOSSIP_HD void store(int i, const Node& x) const { p[i] = x; }
};

// Whether the walk goes on (run_walk's loop condition).
GOSSIP_HD bool walking(const Carry& c, int max_steps, int target) {
  return !c.dead && c.steps < max_steps && c.conv_count < target;
}

// Up to `count` hops from carry c while it walks, hop i under entries[i]
// (the raw word, or the shift for FullPick): step_fn a hop. The node
// absorbs the message unless converged, compares its ratio before and
// after, moves or resets its termRound (reset again when convergence
// fires, program.fs:136), halves and forwards; a converged node relays the
// message untouched (Q5). Then the message goes to the picked neighbour;
// an orphan kills the walk (Q8).
//
// The pick runs a hop ahead: the hop's arithmetic overlaps the next hop's
// pick, whose loads (the entry, and on an explicit topology the row and
// column) touch nothing the walk writes. The next node is read before
// this hop's write, so its latency overlaps the hop's arithmetic too; it
// is forwarded when the walk picks the node it is at (a self-loop). The
// hop two later reads after the write.
template <class Nodes, class Pick>
GOSSIP_HD void walk_block(Carry& c, const Nodes& nodes, const uint32_t* entries,
                          int count, const Pick& pk, int max_steps, int target,
                          float delta, int term_rounds) {
  if (count <= 0 || !walking(c, max_steps, target)) return;
  // The hops this call may take before max_steps.
  const int hops = count < max_steps - c.steps ? count : max_steps - c.steps;
  int cur = c.cur;
  Node x = nodes.load(cur);
  bool ok;
  int nxt = pk.next(entries[0], cur, ok);
  for (int i = 0;;) {
    const int at = pk.real(nxt, cur);
    Node y = nodes.load(at);
    // The next hop's pick, from the node it starts at (a dead walk takes
    // no next hop).
    bool ok_next;
    const int nxt_next = pk.next(entries[i + 1 < count ? i + 1 : i], at, ok_next);
    const float newsum = x.s + c.msg_s;
    const float newweight = x.w + c.msg_w;
    const float ratio = newsum / newweight;
    const float cal = fabsf(x.ratio - ratio);
    if (!(x.tc & 1)) {
      int t = cal > delta ? 0 : (x.tc >> 1) + 1;
      const int fires = t >= term_rounds;
      if (fires) t = 0;
      const float s_half = newsum * 0.5f, w_half = newweight * 0.5f;
      x = Node{s_half, w_half, ratio, t * 2 + fires};
      // A half that fell to a subnormal lost bits: the ratio is that of
      // the halves.
      if (!(s_half * 2.0f == newsum && w_half * 2.0f == newweight))
        x.ratio = s_half / w_half;
      nodes.store(cur, x);
      c.conv_count += fires;
      c.msg_s = x.s;
      c.msg_w = x.w;
    }
    if (at == cur) y = x;
    c.cur = nxt;
    c.steps += 1;
    if (!ok) c.dead = 1;
    cur = at;
    x = y;
    nxt = nxt_next;
    ok = ok_next;
    if (++i >= hops || c.dead || c.conv_count >= target) return;
  }
}

}  // namespace walk
}  // namespace gossip
