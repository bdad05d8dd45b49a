// Per-node logic of the pool kernels in csrc/fused_pool.cu: where a node's
// pool slot lives in the round's packed choice words, its round mark, and
// each receiver's inbox over the round's displacement pool. The imp kernels
// (csrc/imp.cuh) draw their long-range slot from the same packed words.
//
// Plain inline code usable from the host too, so g++ builds it for the CPU
// tests (tests/test_torch_fused_pool_marks.py, tests/test_torch_fused_imp.py),
// which hold it against the JAX package's pool draw and the port's plain
// versions without a GPU.
//
// Layout: the pool layout's [rows, 128] planes, flat index j = row * 128 +
// lane. Node j's pool slot is 4 bits of the packed word at flat position
// (row / 8) * 128 + lane of the round's Threefry stream, sub-slot row % 8
// (sampling.pool_choice_packed).
#pragma once

#include <stdint.h>

#include "stencil.cuh"
#include "faults.cuh"
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

// The packed choice word of node j under the round key (k1, k2): one hash,
// shared by the 8 nodes of j's lane in its group of 8 rows.
GOSSIP_HD uint32_t pool_word(uint32_t k1, uint32_t k2, int j) {
  return threefry_word(k1, k2, choice_counter(j));
}

// Node j's round mark from its packed choice word: its pool slot, the
// index of the round's displacement it sends along; -1 on pad lanes
// (j >= n), which never send.
GOSSIP_HD int8_t pool_mark(uint32_t word, int j, int n, int pool_size) {
  return j < n ? (int8_t)pool_slot(word, choice_sub(j), pool_size) : (int8_t)-1;
}

// The kernels' walk: node `sub` (0..7) of packed word wi, the word's lane
// wi % 128 in row sub of its 8-row group wi / 128. Neighbouring words are
// neighbouring lanes, so a warp's 32 words give 32 consecutive nodes a step.
GOSSIP_HD int word_node(int wi, int sub) {
  return (wi / kChoiceLanes) * (kChoicePack * kChoiceLanes) +
         sub * kChoiceLanes + wi % kChoiceLanes;
}

// Receiver j's push-sum inbox (j < n) under the round's pool `offs` (P
// displacements in [1, n - 1]): over the slots k in ascending order, from
// 0.0, the halved s and w of the slot's source (class_source: j - offs[k]
// mod n) when its mark is k. The halve happens here, on read: s[i] * 0.5f
// is the float the sender's own halving gives, so the sum is the plain
// version's (fused.pushsum_class_rounds) bit for bit. P is a compile-time
// width, so the loop unrolls to straight-line code and every slot's loads
// issue together (the loop to the cap with a test of each slot against the
// kernel's runtime width was slower in an earlier form of the kernel:
// PERF.md §6); each source's s and w are loaded whatever its mark.
template <int P>
GOSSIP_HD void pool_pushsum_inbox(const int* offs, const int8_t* mark,
                                  const float* s, const float* w, int j, int n,
                                  float& in_s, float& in_w) {
  in_s = 0.0f;
  in_w = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = class_source(j, offs[k], n);
    const float si = s[i], wi = w[i];
    const bool hit = mark[i] == k;
    in_s = in_s + (hit ? si * 0.5f : 0.0f);
    in_w = in_w + (hit ? wi * 0.5f : 0.0f);
  }
}

// pool_pushsum_inbox in the faulted instances, where the marks may carry
// kRejoinBit and kLieBit: a source whose mark is the slot sends what
// read_send gives (half of (its index, 0) where it rejoins, the Byzantine
// `mode`'s pair where it lies), and every half and every add is flushed,
// as the plain round flushes them.
template <int P>
GOSSIP_HD void pool_pushsum_inbox_rejoin(const int* offs, const int8_t* mark,
                                         const float* s, const float* w, int j,
                                         int n, float& in_s, float& in_w,
                                         int mode = 0) {
  in_s = 0.0f;
  in_w = 0.0f;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int i = class_source(j, offs[k], n);
    const int8_t m = mark[i];
    float hs, hw;
    read_send(m, i, s[i], w[i], mode, hs, hw);
    const bool hit = mark_hit(m, k);
    in_s = flush(in_s + (hit ? hs : 0.0f));
    in_w = flush(in_w + (hit ? hw : 0.0f));
  }
}

// Receiver j's gossip inbox (j < n): the slot sources whose mark is the
// slot (an inactive sender's mark is -1).
template <int P>
GOSSIP_HD int pool_gossip_inbox(const int* offs, const int8_t* mark, int j,
                                int n) {
  int inbox = 0;
#pragma unroll
  for (int k = 0; k < P; ++k)
    inbox += mark[class_source(j, offs[k], n)] == k ? 1 : 0;
  return inbox;
}

}  // namespace gossip
