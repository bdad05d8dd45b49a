// The reference-semantics push-sum walk on one thread, for Hopper
// (sm_90a): up to `hops` hops a launch, each hop one step of the JAX
// package's models/reference.py step_fn (csrc/walk.cuh).
//
// Replaces no Pallas kernel: the JAX package runs the walk as a
// lax.while_loop of one hop an iteration (models/reference.py run_walk).
// The reference keeps exactly one message in flight, so the walk is a
// chain: hop h + 1 starts where hop h's pick lands. Run as one launch or
// one host step a hop, it would cost a launch and a sync a hop.
//
// What bounds it on this card: latency, not bytes or operations. Each hop
// is a chain of dependent steps: two Threefry hashes of the hop's counter
// (independent of the state, so they overlap the loads), the node's s, w,
// conv and term loads, its degree and neighbour-row load on an explicit
// topology, the float32 divisions, and the next node's index, which the
// next hop's loads wait for. At the reference's sizes (n <= a few
// thousand) the planes stay in the L1 and L2.
//
// Design: one thread in one block walks up to `hops` hops from the carry
// in `scal` (int32 [6]: cur, steps, dead, converged count, the message's s
// and w bits), stopping at death, max_steps or the converged target, and
// writes the carry back; the state planes are updated in place. The host
// reads (steps, converged count, dead) once a launch. Numerics: IEEE
// float32 division and no contraction (-fmad=false), as the JAX step's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

using gossip::walk::Carry;

__global__ void walk_kernel(float* s, float* w, int* term, uint8_t* conv,
                            const int* nbr, const int* deg, int max_deg, int n,
                            int* scal, uint32_t k1, uint32_t k2, int hops,
                            int max_steps, int target, float delta,
                            int term_rounds) {
  Carry c{scal[0], scal[1], scal[2], scal[3], __int_as_float(scal[4]),
          __int_as_float(scal[5])};
  for (int h = 0; h < hops && gossip::walk::walking(c, max_steps, target); ++h) {
    gossip::walk::hop(c, s, w, term, conv,
                      gossip::walk::hop_word(k1, k2, (uint32_t)c.steps), nbr,
                      deg, max_deg, n, delta, term_rounds);
  }
  scal[0] = c.cur;
  scal[1] = c.steps;
  scal[2] = c.dead;
  scal[3] = c.conv_count;
  scal[4] = __float_as_int(c.msg_s);
  scal[5] = __float_as_int(c.msg_w);
}

// The hop chain's unit, measured: one thread follows next[] for `steps`
// dependent loads (i = next[i]) and writes where it ends. Over an array
// the size of the walk's planes it times one load at the walk's working
// set (chip_smoke.py counts the walk's bound in these).
__global__ void chase_kernel(const int* next, int start, int steps, int* out) {
  int i = start;
  for (int k = 0; k < steps; ++k) i = next[i];
  *out = i;
}

}  // namespace

extern "C" int gossip_chase(const int* next, int start, int steps, int* out,
                            int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream_ptr>>>(next, start, steps, out);
  return (int)cudaGetLastError();
}

extern "C" int gossip_walk_hops(float* s, float* w, int* term, uint8_t* conv,
                                const int* nbr, const int* deg, int max_deg,
                                int n, int* scal, unsigned k1, unsigned k2,
                                int hops, int max_steps, int target, float delta,
                                int term_rounds, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  walk_kernel<<<1, 1, 0, (cudaStream_t)stream_ptr>>>(
      s, w, term, conv, nbr, deg, max_deg, n, scal, k1, k2, hops, max_steps,
      target, delta, term_rounds);
  return (int)cudaGetLastError();
}
