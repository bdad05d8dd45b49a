// Per-node logic of the scatter round kernels (csrc/scatter.cu): a sender's
// target on the implicit full topology and on an explicit neighbour table,
// the ordered sum of one target's bucket and a push-sum node's round.
//
// Like threefry.cuh, everything here is plain inline code usable from the
// host, so the CPU tests build it with g++ and hold it against the plain
// torch versions (ops/sampling.targets_full, targets_explicit,
// ops/delivery.deliver and ops/scatter.pushsum_round_plain) without a GPU.
#pragma once

#include <math.h>
#include <stdint.h>

#include "threefry.cuh"

namespace gossip {
namespace scatter {

// Sender i's partner on the implicit complete graph of n nodes under its
// word: the shift 1 + word % (n - 1) in [1, n), mod n (the JAX package's
// targets_full in uint32). n = 1 has no other node: target 0.
GOSSIP_HD int target_full(uint32_t word, int i, int n) {
  if (n < 2) return 0;
  const uint32_t shift = 1u + word % (uint32_t)(n - 1);
  return (int)(((uint32_t)i + shift) % (uint32_t)n);
}

// Sender i's partner on an explicit topology: the neighbour column word %
// degree of its padded row (targets_explicit). Only nodes of degree > 0
// send; the caller skips the others (their zero value would add +0.0).
GOSSIP_HD int target_explicit(uint32_t word, const int* row, int degree) {
  return row[word % (uint32_t)(degree > 0 ? degree : 1)];
}

// One target's bucket of k staged sends (sender index, s half, w half),
// in whatever order the senders were placed: sorts it by sender index in
// place (insertion sort; buckets are small: Poisson(1) on full, at most
// the in-degree on an explicit topology) and adds each channel onto its
// accumulator (acc_s, acc_w) in ascending sender index, the order of a
// serial scatter-add loop.
GOSSIP_HD void bucket_sum(int* idx, float* vs, float* vw, int k, float& acc_s,
                          float& acc_w) {
  for (int a = 1; a < k; ++a) {
    const int i = idx[a];
    const float x = vs[a], y = vw[a];
    int c = a;
    while (c > 0 && idx[c - 1] > i) {
      idx[c] = idx[c - 1];
      vs[c] = vs[c - 1];
      vw[c] = vw[c - 1];
      --c;
    }
    idx[c] = i;
    vs[c] = x;
    vw[c] = y;
  }
  float s = acc_s, w = acc_w;
  for (int a = 0; a < k; ++a) {
    s += vs[a];
    w += vw[a];
  }
  acc_s = s;
  acc_w = w;
}

// One node's push-sum round from its bucket (k staged sends at idx, vs,
// vw), in the op order of the JAX package's jitted round
// (ops/scatter.pushsum_round_plain): the node halves if it sends; the s
// halves add onto its kept half, the w halves into an inbox from 0 that
// is then added to its kept half; it received if that inbox is > 0, and
// the term/conv latch moves as in pushsum.absorb. Sets s_new, w_new,
// t_new and returns the new conv flag.
GOSSIP_HD int pushsum_node(float s_t, float w_t, int t_old, bool conv_old,
                           bool sends, int* idx, float* vs, float* vw, int k,
                           float delta, int term_rounds, float& s_new,
                           float& w_new, int& t_new) {
  const float s_send = sends ? s_t * 0.5f : 0.0f;
  const float w_send = sends ? w_t * 0.5f : 0.0f;
  float acc_s = s_t - s_send, in_w = 0.0f;
  bucket_sum(idx, vs, vw, k, acc_s, in_w);
  s_new = acc_s;
  w_new = (w_t - w_send) + in_w;
  const bool received = in_w > 0.0f;
  const bool stable = fabsf(s_new / w_new - s_t / w_t) <= delta;
  t_new = received ? (stable ? t_old + 1 : 0) : t_old;
  return (conv_old || t_new >= term_rounds) ? 1 : 0;
}

}  // namespace scatter
}  // namespace gossip
