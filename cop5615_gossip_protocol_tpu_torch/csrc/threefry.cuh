// Threefry-2x32 as jax.random draws it (default impl, partitionable
// streams): the device-side counterpart of ops/rng.py.
//
// Everything here is plain inline code usable from the host too, so a
// host compiler (g++) can build it and the CPU tests can hold these words
// against jax.random.bits without a GPU. Only the rotate uses a CUDA
// intrinsic, under __CUDA_ARCH__.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define GOSSIP_HD __host__ __device__ __forceinline__
#else
#define GOSSIP_HD inline
#endif

namespace gossip {

GOSSIP_HD uint32_t rotl32(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

GOSSIP_HD void threefry_group(uint32_t& x0, uint32_t& x1, int r0, int r1,
                              int r2, int r3) {
  x0 += x1; x1 = rotl32(x1, r0) ^ x0;
  x0 += x1; x1 = rotl32(x1, r1) ^ x0;
  x0 += x1; x1 = rotl32(x1, r2) ^ x0;
  x0 += x1; x1 = rotl32(x1, r3) ^ x0;
}

// 20 rounds of Threefry-2x32 on the counter pair (x0, x1), in place.
GOSSIP_HD void threefry2x32(uint32_t k1, uint32_t k2, uint32_t& x0,
                            uint32_t& x1) {
  const uint32_t k3 = k1 ^ k2 ^ 0x1BD11BDAu;
  x0 += k1; x1 += k2;
  threefry_group(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k3 + 1u;
  threefry_group(x0, x1, 17, 29, 16, 24);
  x0 += k3; x1 += k1 + 2u;
  threefry_group(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 3u;
  threefry_group(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k3 + 4u;
  threefry_group(x0, x1, 13, 15, 26, 6);
  x0 += k3; x1 += k1 + 5u;
}

// The 32-bit word jax.random.bits draws at flat position `counter`
// (< 2**32, so the high counter word is 0): the output pair xor-folded.
GOSSIP_HD uint32_t threefry_word(uint32_t k1, uint32_t k2, uint32_t counter) {
  uint32_t x0 = 0u, x1 = counter;
  threefry2x32(k1, k2, x0, x1);
  return x0 ^ x1;
}

// Pool slot of the node in sub-row `sub` (0..7) of a packed choice word:
// 4 bits per node, masked to the power-of-two pool width.
GOSSIP_HD int pool_slot(uint32_t word, int sub, int pool_size) {
  return (int)((word >> (4 * sub)) & (uint32_t)(pool_size - 1));
}

}  // namespace gossip
