// Per-node helpers of the streaming pool kernels (csrc/fused_pool2.cu):
// where a source's packed choice lives, its regenerated choice, the sources
// and choices of one packed-word column (each source the mod-n roll of its
// destination, stencil.cuh's class_source), the push-sum term/conv plane,
// and the faulted kernels' send bits.
//
// Like threefry.cuh, everything here is plain inline code usable from the
// host, so the CPU tests build it with g++ and hold it against the plain
// torch versions without a GPU.
//
// Layout: the pool layout's [rows, 128] planes, flat index j = row * 128 +
// lane. Node j's pool choice is 4 bits of the packed word at flat position
// (row / 8) * 128 + lane of the round's Threefry stream, sub-slot row % 8.
#pragma once

#include <stdint.h>

#include "faults.cuh"
#include "stencil.cuh"
#include "threefry.cuh"

namespace gossip {
namespace pool2 {

constexpr int kLanes = 128;
constexpr int kPack = 8;  // rows (nodes of one lane) per packed choice word

// Push-sum keeps term and conv in one int32 plane: term (a counter bounded
// by the round count, < 2**30) in the low 30 bits, conv in bit 30.
constexpr int kConvBit = 1 << 30;
constexpr int kTermMask = kConvBit - 1;

GOSSIP_HD int tc_pack(int term, bool conv) { return conv ? (term | kConvBit) : term; }
GOSSIP_HD int tc_term(int tc) { return tc & kTermMask; }
GOSSIP_HD bool tc_conv(int tc) { return (tc & kConvBit) != 0; }

// A node's packed plane after a faulted round: the new term and conv if it
// was alive, its round-start plane (frozen) if it was dead.
GOSSIP_HD int tc_frozen(bool alive, int tc, int t_new, bool conv) {
  return alive ? tc_pack(t_new, conv) : tc;
}

// Flat position of node i's packed choice word, and i's 4-bit sub-slot in it.
GOSSIP_HD uint32_t choice_word_index(int i) {
  return (uint32_t)((i >> 10) * kLanes + (i & (kLanes - 1)));
}
GOSSIP_HD int choice_sub(int i) { return (i >> 7) & (kPack - 1); }

// Node i's pool slot under the round key (k1, k2); pad lanes (i >= n)
// choose no slot (-1).
GOSSIP_HD int source_choice(uint32_t k1, uint32_t k2, int i, int n, int pool_size) {
  if (i >= n) return -1;
  return pool_slot(threefry_word(k1, k2, choice_word_index(i)), choice_sub(i), pool_size);
}

// Sources and their pool choices for the 8 destinations j0 + 128 * sub
// (sub 0..7) of one packed-word column (rows 8q..8q+7 of one lane, j0 =
// q * 1024 + lane) under the mod-n displacement d; returns the Threefry
// words drawn. When all 8 sources are unwrapped (j0 >= d) or all wrapped
// (the last destination < d), they are i0 + 128 * sub: one lane, 8
// consecutive rows, so at most 2 packed words, drawn once each. Only the
// column the wrap cuts through (j0 < d <= j0 + 896, one per lane) draws a
// word per source.
GOSSIP_HD int column_sources(int j0, int d, int n, uint32_t k1, uint32_t k2,
                             int pool_size, int src[kPack], int ch[kPack]) {
  const int last = j0 + (kPack - 1) * kLanes;
  if (j0 >= d || last < d) {
    const int i0 = class_source(j0, d, n);
    const int r0 = i0 >> 7, lane = i0 & (kLanes - 1), wr = r0 >> 3;
    const uint32_t wa = threefry_word(k1, k2, (uint32_t)(wr * kLanes + lane));
    const uint32_t wb = threefry_word(k1, k2, (uint32_t)((wr + 1) * kLanes + lane));
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int sub = 0; sub < kPack; ++sub) {
      const int r = r0 + sub;
      src[sub] = i0 + sub * kLanes;
      ch[sub] = src[sub] >= n ? -1
                              : pool_slot((r >> 3) == wr ? wa : wb, r & (kPack - 1), pool_size);
    }
    return 2;
  }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int sub = 0; sub < kPack; ++sub) {
    src[sub] = class_source(j0 + sub * kLanes, d, n);
    ch[sub] = source_choice(k1, k2, src[sub], n, pool_size);
  }
  return kPack;
}

// The faulted kernels' send bits: one bit a node, set iff the node sends
// in the round (faults.cuh send_flag), in a byte plane laid out as the
// packed choice words: node i's bit is bit choice_sub(i) of byte
// choice_word_index(i), so the 8 destinations of packed-word column `col`
// (local_column_origin) own byte `col`, bit sub for j0 + 128 * sub.
GOSSIP_HD bool send_bit(const uint8_t* sends, int i) {
  return ((sends[choice_word_index(i)] >> choice_sub(i)) & 1u) != 0;
}

// column_sources with the failure model folded in: a source whose send bit
// is clear chooses no slot (-1), so it delivers nothing (the JAX kernels'
// masked_choice). Where the 8 sources share one lane on 8 consecutive rows
// their bits lie in at most 2 bytes, read once each (the second only when
// the rows cross a byte); the wrap column reads a byte per source. Returns
// column_sources' Threefry words drawn.
GOSSIP_HD int column_sources_sending(int j0, int d, int n, uint32_t k1,
                                     uint32_t k2, int pool_size,
                                     const uint8_t* sends, int src[kPack],
                                     int ch[kPack]) {
  const int drawn = column_sources(j0, d, n, k1, k2, pool_size, src, ch);
  if (drawn == 2) {
    const int r0 = src[0] >> 7, lane = src[0] & (kLanes - 1), wr = r0 >> 3;
    const uint32_t ba = sends[wr * kLanes + lane];
    const uint32_t bb = (r0 & (kPack - 1)) ? sends[(wr + 1) * kLanes + lane] : 0u;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int sub = 0; sub < kPack; ++sub) {
      const int r = r0 + sub;
      if (!((((r >> 3) == wr ? ba : bb) >> (r & (kPack - 1))) & 1u)) ch[sub] = -1;
    }
  } else {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int sub = 0; sub < kPack; ++sub)
      if (!send_bit(sends, src[sub])) ch[sub] = -1;
  }
  return drawn;
}

// ------------------------------------------------ the sharded composition
//
// csrc/fused_pool2_shard.cu runs one round over the rows a device owns in
// the replicated-pool2 composition: global rows [row0, row0 + rows) of the
// [R, 128] layout (row0 a multiple of 8, so a packed-word column never
// straddles two shards), reading every source from the device's global
// copy of the summary planes at the source's own global index.

// Local flat index of the first destination of packed-word column `col`
// (rows 8q..8q+7 of one lane) of a device's rows; csrc/fused_pool2.cu's
// column origin.
GOSSIP_HD int local_column_origin(int col) {
  return (col >> 7) * (kPack * kLanes) + (col & (kLanes - 1));
}

// Global flat index of that destination on the rows starting at row0.
GOSSIP_HD int shard_column_origin(int col, int row0) {
  return row0 * kLanes + local_column_origin(col);
}

// The reads of pool slot `slot` (displacement d) for the 8 destinations
// j0 + 128 * sub of one packed-word column (j0 global): at[sub], the flat
// index of the destination's mod-n source in a global [R, 128] summary
// plane, which is the source's own global index (class_source: a
// conditional add of n, no modulo), and hit[sub], whether that source
// chose the slot and the destination is real. A summary value is read
// only where hit is set.
GOSSIP_HD void slot_reads(int j0, int d, int n, uint32_t k1, uint32_t k2,
                          int pool_size, int slot, int at[kPack],
                          bool hit[kPack]) {
  int ch[kPack];
  column_sources(j0, d, n, k1, k2, pool_size, at, ch);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int sub = 0; sub < kPack; ++sub)
    hit[sub] = ch[sub] == slot && j0 + sub * kLanes < n;
}

}  // namespace pool2
}  // namespace gossip
