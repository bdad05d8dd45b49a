// Per-node logic of the scatter round kernels (csrc/scatter.cu): a round's
// key, a sender's target on the implicit full topology and on an explicit
// neighbour table, the dup gate, a send's 16-byte record, the ordered sum of
// one target's bucket (with the dup gate's second copies apart), a push-sum
// node's round, the delay ring's slot, and the contiguous slices of targets
// the blocks of the persistent launch own.
//
// Like threefry.cuh, everything here is plain inline code usable from the
// host, so the CPU tests build it with g++ and hold it against the plain
// torch versions (ops/sampling.targets_full, targets_explicit,
// ops/delivery.deliver and ops/scatter.pushsum_round_plain) without a GPU,
// and emulate the kernel's passes with it.
#pragma once

#include <math.h>
#include <stdint.h>

#include "faults.cuh"
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

// The fold_in key of absolute round `round` (mod 2**32) under the run's
// key (k1, k2): the Threefry pair at counter (0, round), as
// ops/fused.round_keys draws it on the host.
GOSSIP_HD void round_key(uint32_t k1, uint32_t k2, uint32_t round, uint32_t& r1,
                         uint32_t& r2) {
  r1 = 0u;
  r2 = round;
  threefry2x32(k1, k2, r1, r2);
}

// fold_in tag of the dup gate (ops/sampling.DUP_TAG), folded into the
// round key: the dup key of a round is the Threefry pair at (0, tag).
constexpr uint32_t kDupTag = 0xD00Bu;

// The dup key of the round whose fold_in key is (r1, r2).
GOSSIP_HD void dup_key(uint32_t r1, uint32_t r2, uint32_t& d1, uint32_t& d2) {
  d1 = 0u;
  d2 = kDupTag;
  threefry2x32(r1, r2, d1, d2);
}

// Whether node j's message is delivered twice this round
// (ops/sampling.dup_gate): its word at flat position j of the dup stream
// is below the threshold (a threshold of 0 never fires).
GOSSIP_HD bool dup_fires(uint32_t d1, uint32_t d2, uint32_t thresh, int j) {
  return threefry_word(d1, d2, (uint32_t)j) < thresh;
}

// The delay ring's slot of absolute round `round` under depth D: read, then
// overwritten with the round's fresh inbox (the JAX runner's
// lax.rem(round_idx, D)).
GOSSIP_HD int ring_slot(int round, int D) { return round % D; }

// One staged push-sum send: the sender's index and its halves, padded to
// 16 bytes so a send is one vector store and a bucket entry one vector load.
// In the dup instances the index word is 2 i + the sender's dup bit
// (dup_index), which sorts as i does and keeps the pad word dead, so a
// bucket sorted in registers takes no more of them.
struct alignas(16) Send {
  int idx;
  float s;
  float w;
  int pad;
};

// Sender i's record from its round-start s and w; with Flush (the faulted
// instance) its halves flushed (csrc/faults.cuh flush), and where it lies
// (a Byzantine `mode`, 0 for none) the mode's pair (lie_send).
template <bool Flush = false>
GOSSIP_HD Send make_send(int i, float s_t, float w_t, int mode = 0) {
  if (!Flush) return Send{i, s_t * 0.5f, w_t * 0.5f, 0};
  Send v{i, flush(s_t * 0.5f), flush(w_t * 0.5f), 0};
  lie_send(mode, s_t, w_t, v.s, v.w);
  return v;
}

// A dup instance's index word of sender i: 2 i + its dup bit (n < 2**30).
GOSSIP_HD int dup_index(int i, bool dup) { return 2 * i + (dup ? 1 : 0); }

GOSSIP_HD void store_send(Send* at, Send v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(at) =
      make_int4(v.idx, __float_as_int(v.s), __float_as_int(v.w), 0);
#else
  *at = v;
#endif
}

GOSSIP_HD Send load_send(const Send* at) {
#ifdef __CUDA_ARCH__
  const int4 q = *reinterpret_cast<const int4*>(at);
  return Send{q.x, __int_as_float(q.y), __int_as_float(q.z), 0};
#else
  return *at;
#endif
}

// Buckets up to this many sends are sorted in registers; a larger one
// (Poisson(1) on full: about one bucket in a million) is summed by repeated
// selection from memory.
constexpr int kSortMax = 8;

// Adds one target's bucket of k sends onto (acc_s, acc_w) in ascending
// sender index, the order of a serial scatter-add loop, whatever order the
// sends were placed in; send a is get(a). No float atomic and no write.
// With Flush (the faulted instance) every add is flushed.
template <bool Flush = false, typename Get>
GOSSIP_HD void ordered_sum(Get get, int k, float& acc_s, float& acc_w) {
  float s = acc_s, w = acc_w;
  if (k <= kSortMax) {
    // Fully unrolled with compile-time indices, so the bucket stays in
    // registers: an insertion sort by adjacent compare-exchange.
    Send v[kSortMax];
#pragma unroll
    for (int a = 0; a < kSortMax; ++a)
      if (a < k) v[a] = get(a);
#pragma unroll
    for (int a = 1; a < kSortMax; ++a) {
      if (a < k) {
#pragma unroll
        for (int c = a; c > 0; --c) {
          if (v[c - 1].idx > v[c].idx) {
            const Send x = v[c - 1];
            v[c - 1] = v[c];
            v[c] = x;
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kSortMax; ++a) {
      if (a < k) {
        s = Flush ? flush(s + v[a].s) : s + v[a].s;
        w = Flush ? flush(w + v[a].w) : w + v[a].w;
      }
    }
  } else {
    // Each step adds the send with the least index above the last one.
    int last = -1;
    for (int step = 0; step < k; ++step) {
      Send best{0x7fffffff, 0.0f, 0.0f, 0};
      for (int a = 0; a < k; ++a) {
        const Send x = get(a);
        if (x.idx > last && x.idx < best.idx) best = x;
      }
      s = Flush ? flush(s + best.s) : s + best.s;
      w = Flush ? flush(w + best.w) : w + best.w;
      last = best.idx;
    }
  }
  acc_s = s;
  acc_w = w;
}

// ordered_sum over a bucket of 16-byte records.
template <bool Flush = false>
GOSSIP_HD void record_sum(const Send* rec, int k, float& acc_s, float& acc_w) {
  ordered_sum<Flush>([&](int a) { return load_send(rec + a); }, k, acc_s,
                     acc_w);
}

// The dup instances' bucket sum: in ascending sender index, every send adds
// onto (b_s, b_w) and a dup-gated one (an odd index word, dup_index) onto
// (c_s, c_w) as well,
// every add flushed: the two inboxes from 0 of the JAX runner's make_df,
// deliver(v) and deliver(where(dup, v, 0)), in a serial scatter-add's order
// (adding a non-gated sender's +0.0 to the second changes nothing).
template <typename Get>
GOSSIP_HD void ordered_sum_dup(Get get, int k, float& b_s, float& b_w,
                               float& c_s, float& c_w) {
  float bs = b_s, bw = b_w, cs = c_s, cw = c_w;
  const auto add = [&](const Send& x) {
    bs = flush(bs + x.s);
    bw = flush(bw + x.w);
    if (x.idx & 1) {
      cs = flush(cs + x.s);
      cw = flush(cw + x.w);
    }
  };
  if (k <= kSortMax) {
    Send v[kSortMax];
#pragma unroll
    for (int a = 0; a < kSortMax; ++a)
      if (a < k) v[a] = get(a);
#pragma unroll
    for (int a = 1; a < kSortMax; ++a) {
      if (a < k) {
#pragma unroll
        for (int c = a; c > 0; --c) {
          if (v[c - 1].idx > v[c].idx) {
            const Send x = v[c - 1];
            v[c - 1] = v[c];
            v[c] = x;
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < kSortMax; ++a)
      if (a < k) add(v[a]);
  } else {
    int last = -1;
    for (int step = 0; step < k; ++step) {
      Send best{0x7fffffff, 0.0f, 0.0f, 0};
      for (int a = 0; a < k; ++a) {
        const Send x = get(a);
        if (x.idx > last && x.idx < best.idx) best = x;
      }
      add(best);
      last = best.idx;
    }
  }
  b_s = bs;
  b_w = bw;
  c_s = cs;
  c_w = cw;
}

// One bucket's inbox pair in the dup and delay instances, summed from 0:
// with Dup the sum of both inboxes of ordered_sum_dup, flushed (XLA adds
// the two scatters; it folds neither onto the other nor onto a kept half),
// else the plain ordered sum.
template <bool Dup>
GOSSIP_HD void record_inbox(const Send* rec, int k, float& in_s, float& in_w) {
  float bs = 0.0f, bw = 0.0f;
  if (Dup) {
    float cs = 0.0f, cw = 0.0f;
    ordered_sum_dup([&](int a) { return load_send(rec + a); }, k, bs, bw, cs,
                    cw);
    in_s = flush(bs + cs);
    in_w = flush(bw + cw);
  } else {
    ordered_sum<true>([&](int a) { return load_send(rec + a); }, k, bs, bw);
    in_s = bs;
    in_w = bw;
  }
}

// One node's push-sum round, in the op order of the JAX package's jitted
// round (ops/scatter.pushsum_round_plain): the node halves if it sends;
// add_bucket(acc_s, in_w) adds its bucket's s halves onto its kept half and
// its w halves into an inbox from 0 that is then added to its kept half; it
// received if that inbox is > 0, and the term/conv latch moves as in
// pushsum.absorb. Sets s_new, w_new, t_new and returns the new conv flag.
// With Flush (the faulted instance) the kept halves are keep_flushed's
// (the scatter round's folded form) and the last sum is flushed; the
// bucket's adds are add_bucket's to flush.
template <bool Flush = false, typename AddBucket>
GOSSIP_HD int pushsum_round(float s_t, float w_t, int t_old, bool conv_old,
                            bool sends, AddBucket add_bucket, float delta,
                            int term_rounds, float& s_new, float& w_new,
                            int& t_new) {
  float acc_s, w_keep, in_w = 0.0f;
  if (Flush) {
    keep_flushed<true>(s_t, w_t, sends, acc_s, w_keep);
  } else {
    acc_s = s_t - (sends ? s_t * 0.5f : 0.0f);
    w_keep = w_t - (sends ? w_t * 0.5f : 0.0f);
  }
  add_bucket(acc_s, in_w);
  s_new = acc_s;
  w_new = Flush ? flush(w_keep + in_w) : w_keep + in_w;
  const bool received = in_w > 0.0f;
  const bool stable = fabsf(s_new / w_new - s_t / w_t) <= delta;
  t_new = received ? (stable ? t_old + 1 : 0) : t_old;
  return (conv_old || t_new >= term_rounds) ? 1 : 0;
}

// One node's push-sum round from its whole inboxes (in_s, in_w), the form of
// the dup and delay instances (ops/scatter.pushsum_round_plain with dup or a
// ring): the kept halves as keep_flushed's, each plus its inbox, flushed; it
// received if in_w > 0. Sets s_new, w_new, t_new and returns the new conv
// flag, as pushsum_round does.
GOSSIP_HD int pushsum_round_inbox(float s_t, float w_t, int t_old,
                                  bool conv_old, bool sends, float in_s,
                                  float in_w, float delta, int term_rounds,
                                  float& s_new, float& w_new, int& t_new) {
  float s_keep, w_keep;
  keep_flushed<true>(s_t, w_t, sends, s_keep, w_keep);
  s_new = flush(s_keep + in_s);
  w_new = flush(w_keep + in_w);
  const bool received = in_w > 0.0f;
  const bool stable = fabsf(s_new / w_new - s_t / w_t) <= delta;
  t_new = received ? (stable ? t_old + 1 : 0) : t_old;
  return (conv_old || t_new >= term_rounds) ? 1 : 0;
}

// robust_agg="clip"'s factor of a receiver's inbox (models/pushsum.
// clip_scale): it accepts at most cap = 2 * max(w_keep, 1) of weight a
// round, so an inbox over the cap scales by cap / in_w, and one with in_w
// <= 0 is dropped (0). A NaN kept half makes the cap NaN, as torch.maximum
// does.
GOSSIP_HD float clip_scale(float in_w, float w_keep) {
  const float base = (w_keep != w_keep || w_keep > 1.0f) ? w_keep : 1.0f;
  const float cap = flush(2.0f * base);
  const float scale = in_w > cap ? flush(cap / in_w) : 1.0f;
  return in_w > 0.0f ? scale : 0.0f;
}

// One node's push-sum round under clip (ops/scatter.pushsum_round_plain
// with clip, models/pushsum.absorb_clipped): the kept halves as the faulted
// round keeps them (keep_flushed), add_bucket(in_s, in_w) sums the bucket's
// halves from 0 (flushed adds), and each kept half takes its inbox times
// the clip's scale in one fused multiply-add, flushed, as XLA contracts it;
// the node received if its scaled w inbox is > 0. Sets s_new, w_new, t_new
// and returns the new conv flag.
template <typename AddBucket>
GOSSIP_HD int pushsum_round_clipped(float s_t, float w_t, int t_old,
                                    bool conv_old, bool sends,
                                    AddBucket add_bucket, float delta,
                                    int term_rounds, float& s_new,
                                    float& w_new, int& t_new) {
  float s_keep, w_keep, in_s = 0.0f, in_w = 0.0f;
  keep_flushed<true>(s_t, w_t, sends, s_keep, w_keep);
  add_bucket(in_s, in_w);
  const float scale = clip_scale(in_w, w_keep);
  s_new = flush(fmaf(in_s, scale, s_keep));
  w_new = flush(fmaf(in_w, scale, w_keep));
  const bool received = flush(in_w * scale) > 0.0f;
  const bool stable = fabsf(s_new / w_new - s_t / w_t) <= delta;
  t_new = received ? (stable ? t_old + 1 : 0) : t_old;
  return (conv_old || t_new >= term_rounds) ? 1 : 0;
}

// The contiguous slices of the n targets among the blocks of the persistent
// launch: block b owns [b * size, min((b + 1) * size, n)), which is empty
// for trailing blocks when size * blocks > n. Each block scans its slice's
// bucket counts; a bucket starts at its block's base (the totals of the
// blocks before it) plus its offset inside the slice.
struct Slices {
  int n;
  int size;
};

GOSSIP_HD Slices make_slices(int n, int blocks) {
  return Slices{n, (int)(((long long)n + blocks - 1) / blocks)};
}

GOSSIP_HD int slice_lo(const Slices& sl, int b) {
  const long long lo = (long long)b * sl.size;
  return (int)(lo < sl.n ? lo : sl.n);
}

GOSSIP_HD int slice_hi(const Slices& sl, int b) {
  const long long hi = ((long long)b + 1) * sl.size;
  return (int)(hi < sl.n ? hi : sl.n);
}

GOSSIP_HD int slice_of(const Slices& sl, int t) { return t / sl.size; }

// A sender's (target, rank) for the next round: its target (-1 when it does
// not send) and its rank in the target's bucket, which the counting atomic
// returns, so the place pass needs no atomic of its own.
struct alignas(8) Ticket {
  int target;
  int rank;
};

}  // namespace scatter
}  // namespace gossip
