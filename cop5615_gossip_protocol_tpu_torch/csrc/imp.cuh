// Per-node logic of the imp kernels in csrc/fused_imp.cu and
// csrc/fused_imp_hbm_shard.cu: the class an imp2d/imp3d node sends along
// this round under pooled long-range sampling, read through its static
// directions word, the packed choice word its pool slot comes from
// (csrc/pool.cuh), and each receiver's inbox over the lattice and pool
// classes. The device-side counterpart of
// ops/fused_imp.py's imp_marks and of the absorbs of
// parallel/fused_imp_hbm_sharded.py.
//
// Plain inline code usable from the host too, so g++ builds it for the CPU
// tests (tests/test_torch_fused_imp.py, tests/test_torch_imp_shard_host.py),
// which hold it against the JAX package's imp sampling and the port's plain
// versions without a GPU.
#pragma once

#include <stdint.h>

#include "pool.cuh"
#include "stencil.cuh"
#include "threefry.cuh"

namespace gossip {

// The lattice class id a real node j (< n) sends along, from its
// directions word (ops/fused_imp.imp_dir_words: bits 4k..4k+3 the class id
// of its k-th live lattice direction in the grid's column order, its
// lattice degree in bits 24..26) and its slot word `bits`: slot = bits %
// (degree + 1) over the live lattice directions and, last, the long-range
// slot (slot == degree, live on every real node), for which it returns -1.
// At grid side 2 two directions share a displacement, so the word holds one
// class id twice. A word of 0 still sends: its one slot is the long-range
// one, so "real" is j < n, never a nonzero word.
GOSSIP_HD int imp_lattice_class(uint32_t word, uint32_t bits) {
  const uint32_t deg = word >> 24;
  const uint32_t slot = bits % (deg + 1u);
  return slot == deg ? -1 : (int)((word >> (4u * slot)) & 15u);
}

// Round mark of real node j under the round key (k1, k2) and choice key
// (c1, c2): its lattice class, or for the long-range slot class
// lattice_count + its pool slot in the packed choice word of its 8-row
// group, threefry_word(c1, c2, choice_counter(j)), which is hashed only
// then.
GOSSIP_HD int8_t imp_mark(uint32_t word, uint32_t k1, uint32_t k2, uint32_t c1,
                          uint32_t c2, int j, int pool_size,
                          int lattice_count) {
  const int q = imp_lattice_class(word, threefry_word(k1, k2, (uint32_t)j));
  if (q >= 0) return (int8_t)q;
  return (int8_t)(lattice_count +
                  pool_slot(threefry_word(c1, c2, choice_counter(j)),
                            choice_sub(j), pool_size));
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
// registers and every class's mark load is in flight at once. A lattice
// source's s and w are loaded whatever its mark (it lies within +-g*g
// nodes, so they hit the L2 and are in flight with the mark loads); a pool
// source's only when its mark is the class, since each pool class reads a
// window a random distance away and a load there can cost an HBM sector.
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
      if (lat) {
        const float si = s[i], wi = w[i];
        const bool hit = mark[i] == k;
        vs = hit ? si * 0.5f : 0.0f;
        vw = hit ? wi * 0.5f : 0.0f;
      } else if (mark[i] == lattice.count + k) {
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
