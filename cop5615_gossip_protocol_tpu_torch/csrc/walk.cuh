// One hop of the reference-semantics push-sum walk (csrc/walk.cu): the
// hop's random word, the neighbour pick and the node's update, the JAX
// package's models/reference.py step_fn in float32.
//
// Like threefry.cuh, everything here is plain inline code usable from the
// host, so the CPU tests build it with g++ and hold it against the JAX
// step function without a GPU.
#pragma once

#include <math.h>
#include <stdint.h>

#include "scatter.cuh"
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

// A uniform neighbour of `node` under `word` (pick_neighbor): on full
// (nbr null) the shift partner, else the neighbour column word % degree;
// `ok` is false for a degree-0 orphan (whose pick is its padded column 0).
GOSSIP_HD int pick(uint32_t word, int node, const int* nbr, const int* deg,
                   int max_deg, int n, bool& ok) {
  if (nbr == nullptr) {
    ok = true;
    return scatter::target_full(word, node, n);
  }
  const int d = deg[node];
  ok = d > 0;
  return scatter::target_explicit(word, nbr + (long long)node * max_deg, d);
}

// One hop (step_fn): node c.cur absorbs the message unless converged,
// compares its ratio before and after, moves or resets its termRound
// (reset again when convergence fires, program.fs:136), halves and
// forwards; a converged node relays the message untouched (Q5). Then the
// message goes to a neighbour picked with `word`; an orphan kills the
// walk (Q8).
GOSSIP_HD void hop(Carry& c, float* s, float* w, int* term, uint8_t* conv,
                   uint32_t word, const int* nbr, const int* deg, int max_deg,
                   int n, float delta, int term_rounds) {
  const int cur = c.cur;
  const float s_c = s[cur], w_c = w[cur];
  const float newsum = s_c + c.msg_s;
  const float newweight = w_c + c.msg_w;
  const float cal = fabsf(s_c / w_c - newsum / newweight);
  if (!conv[cur]) {
    int term_new = cal > delta ? 0 : term[cur] + 1;
    const bool fires = term_new >= term_rounds;
    if (fires) term_new = 0;
    const float s_half = newsum * 0.5f, w_half = newweight * 0.5f;
    s[cur] = s_half;
    w[cur] = w_half;
    term[cur] = term_new;
    c.msg_s = s_half;
    c.msg_w = w_half;
    if (fires) {
      conv[cur] = 1;
      c.conv_count += 1;
    }
  }
  bool ok;
  c.cur = pick(word, cur, nbr, deg, max_deg, n, ok);
  c.steps += 1;
  if (!ok) c.dead = 1;
}

// Whether the walk goes on (run_walk's loop condition).
GOSSIP_HD bool walking(const Carry& c, int max_steps, int target) {
  return !c.dead && c.steps < max_steps && c.conv_count < target;
}

}  // namespace walk
}  // namespace gossip
