// The reference-semantics push-sum walk for Hopper (sm_90a): up to `hops`
// hops a launch, each hop one step of the JAX package's models/reference.py
// step_fn (csrc/walk.cuh walk_block).
//
// Replaces no Pallas kernel: the JAX package runs the walk as a
// lax.while_loop of one hop an iteration (models/reference.py run_walk).
// The reference keeps exactly one message in flight, so the walk is a
// chain: hop h + 1 starts where hop h's pick lands.
//
// What bounds it on this card: latency, not bytes or operations. A hop is
// a chain of dependent steps on one thread: the node's record, the float32
// division, the latch and the stop test, and the next node's index, which
// the next hop's load waits for; on an explicit topology the next node is
// two dependent loads (the node's staged row, then its neighbour column).
// What no design can take off the chain is less: on full the message's
// add and multiply (arith_kernel below), on an explicit topology the two
// loads (chase_kernel).
// Whatever can leave that chain does:
//
// - The hop's word (two Threefry hashes of the hop count) depends on the
//   count alone. One block of kThreads threads: thread 0 walks, warps 1..
//   draw the next kRing hops' entries into the other half of a ring in
//   shared memory while it walks this half, indexed by the absolute hop
//   count. On full the entry is the shift 1 + word % (n - 1), so the
//   walker's pick is an add and an unsigned minimum. One barrier a kRing
//   hops (__syncthreads_or carries the walker's stop to every thread, so
//   every thread reaches every barrier and leaves together).
// - On an explicit topology each node's row is staged with its degree and
//   its fastmod constant beside its neighbour columns (walk.cuh
//   stage_row): no division on the walker's path.
// - A node is one 16-byte record (s, w, its ratio s / w, termRound and
//   conv), one load and one store a hop; the ratio kept from its last
//   visit leaves one division a hop of step_fn's two. The next node is
//   read before this hop's write, so its latency overlaps the arithmetic.
// - Shared tier: when the records (16 B a node) and, on an explicit
//   topology, the rows fit the opt-in shared memory beside the ring, the
//   block stages them there at launch start, walks there and writes the
//   planes back at the end. Global tier otherwise: the same staging into
//   scratch the wrapper allocates. The host picks the tier by size before
//   the launch (gossip_walk_tier).
//
// The carry is in `scal` (int32 [6]: cur, steps, dead, converged count,
// the message's s and w bits); the host reads (steps, converged count,
// dead) once a launch. The carry written back is the one at the exact
// stop hop; entries drawn past it are dropped. Numerics: IEEE float32
// division and no contraction (-fmad=false), as the JAX step's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "walk.cuh"

namespace {

using gossip::walk::Carry;

constexpr int kThreads = 256;
// Hops a half of the ring holds: the walker's span between barriers.
constexpr int kRing = 1024;

struct WalkArgs {
  float* s;
  float* w;
  int* term;
  uint8_t* conv;
  const int* nbr;
  const int* deg;
  void* scratch;  // the global tier's records and rows
  int max_deg;
  int n;
  int* scal;
  uint32_t k1, k2;
  int hops;
  int max_steps;
  int target;
  float delta;
  int term_rounds;
};

// Bytes of the walk's records and, on an explicit topology, rows: shared
// memory of the shared tier beside the ring, scratch of the global tier.
size_t walk_bytes(int n, int max_deg, bool full) {
  const size_t rows = full ? 0 : (size_t)n * gossip::walk::row_stride(max_deg);
  return (size_t)n * sizeof(gossip::walk::Node) + 4 * rows;
}

// The entries of hops [k * kRing, (k + 1) * kRing) into ring half k & 1,
// thread `t` of `threads`.
template <bool kFull>
__device__ void draw(uint32_t* ring, long long k, int t, int threads,
                     const WalkArgs& a) {
  uint32_t* half = ring + (k & 1) * kRing;
  for (int j = t; j < kRing; j += threads) {
    const uint32_t word =
        gossip::walk::hop_word(a.k1, a.k2, (uint32_t)(k * kRing + j));
    half[j] = kFull ? gossip::walk::full_shift(word, a.n) : word;
  }
}

template <bool kShared, bool kFull>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(WalkArgs a) {
  using gossip::walk::Node;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;
  const int n = a.n, stride = gossip::walk::row_stride(a.max_deg);
  Node* nodes = kShared ? (Node*)(ring + 2 * kRing) : (Node*)a.scratch;
  int* rows = (int*)(nodes + n);
  const int t = threadIdx.x;
  for (int i = t; i < n; i += kThreads) {
    nodes[i] = gossip::walk::make_node(a.s[i], a.w[i], a.term[i], a.conv[i]);
    if (!kFull) gossip::walk::stage_row(rows, i, a.nbr, a.deg, a.max_deg);
  }
  Carry c{a.scal[0], a.scal[1], a.scal[2], a.scal[3], __int_as_float(a.scal[4]),
          __int_as_float(a.scal[5])};
  const long long end = (long long)c.steps + a.hops;
  long long k = c.steps / kRing;
  draw<kFull>(ring, k, t, kThreads, a);
  __syncthreads();
  const gossip::walk::Records walker{nodes};
  const gossip::walk::FullPick full{n};
  const gossip::walk::RowPick row{rows, stride, n};
  for (;;) {
    int stop = 0;
    if (t == 0) {
      const long long lim = ((k + 1) * kRing < end ? (k + 1) * kRing : end) - c.steps;
      const uint32_t* at = ring + (c.steps % (2 * kRing));
      if (kFull)
        gossip::walk::walk_block(c, walker, at, (int)lim, full, a.max_steps, a.target,
                                 a.delta, a.term_rounds);
      else
        gossip::walk::walk_block(c, walker, at, (int)lim, row, a.max_steps, a.target,
                                 a.delta, a.term_rounds);
      stop = !gossip::walk::walking(c, a.max_steps, a.target) || c.steps >= end;
    } else if (t >= 32) {
      draw<kFull>(ring, k + 1, t - 32, kThreads - 32, a);
    }
    if (__syncthreads_or(stop)) break;
    ++k;
  }
  if (t == 0) {
    a.scal[0] = c.cur;
    a.scal[1] = c.steps;
    a.scal[2] = c.dead;
    a.scal[3] = c.conv_count;
    a.scal[4] = __float_as_int(c.msg_s);
    a.scal[5] = __float_as_int(c.msg_w);
  }
  for (int i = t; i < n; i += kThreads) {
    const Node x = nodes[i];
    a.s[i] = x.s;
    a.w[i] = x.w;
    a.term[i] = x.tc >> 1;
    a.conv[i] = (uint8_t)(x.tc & 1);
  }
}

template <bool kShared, bool kFull>
cudaError_t launch(const WalkArgs& a, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(walk_kernel<kShared, kFull>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  walk_kernel<kShared, kFull><<<1, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The hop chain's unit, measured: one thread follows next[] for `steps`
// dependent loads (i = next[i]) and writes where it ends, over global
// memory (through the L1 and L2) or, `shared`, over a copy of the m ints
// in shared memory. Over an array the size of the walk's working set it
// times one dependent access in the memory the walk's tier walks in
// (chip_smoke.py counts the walk's bound in these).
template <bool kShared>
__global__ void chase_kernel(const int* next, int m, int start, int steps,
                             int* out) {
  extern __shared__ int copy[];
  const int* at = next;
  if (kShared) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) copy[i] = next[i];
    __syncthreads();
    at = copy;
  }
  if (threadIdx.x != 0) return;
  int i = start;
  for (int k = 0; k < steps; ++k) i = at[i];
  *out = i;
}

// The other unit: a hop's loop-carried arithmetic, measured. One thread
// runs `steps` times, with no memory, the recurrences that tie one hop to
// the next when the node's record comes in off the chain (on full, where
// the walker reads it a hop ahead): the message, newsum = s + msg then
// msg = newsum * 0.5 (an add and a multiply, no contraction), for s and
// w; and, `kIndex`, the full pick's next node (an add and an unsigned
// minimum). Its time a step is the least a hop can take on full.
template <bool kIndex>
__global__ void arith_kernel(uint32_t shift, int n, float s, float w, int steps,
                             int* out) {
  float ms = s, mw = w;
  uint32_t cur = 0;
  for (int k = 0; k < steps; ++k) {
    ms = (s + ms) * 0.5f;
    mw = (w + mw) * 0.5f;
    if (kIndex) {
      const uint32_t x = cur + shift, y = x - (uint32_t)n;
      cur = y < x ? y : x;
    }
  }
  out[0] = __float_as_int(ms);
  out[1] = __float_as_int(mw);
  out[2] = (int)cur;
}

}  // namespace

extern "C" int gossip_arith_chain(unsigned shift, int n, float s, float w, int steps,
                                  int index, int* out, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (index)
    arith_kernel<true><<<1, 1, 0, stream>>>(shift, n, s, w, steps, out);
  else
    arith_kernel<false><<<1, 1, 0, stream>>>(shift, n, s, w, steps, out);
  return (int)cudaGetLastError();
}

extern "C" int gossip_chase(const int* next, int m, int start, int steps, int* out,
                            int shared, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (shared) {
    const size_t bytes = (size_t)m * sizeof(int);
    err = cudaFuncSetAttribute(chase_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    chase_kernel<true><<<1, kThreads, bytes, stream>>>(next, m, start, steps, out);
  } else {
    chase_kernel<false><<<1, 1, 0, stream>>>(next, m, start, steps, out);
  }
  return (int)cudaGetLastError();
}

// The walk's tier by size: 1 (shared) when its records, rows and ring fit
// the device's opt-in shared memory a block, else 0 (global), whose
// scratch takes *scratch_bytes; -1 when the limit cannot be read.
extern "C" int gossip_walk_tier(int n, int max_deg, int full, int device,
                                long long* scratch_bytes) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  const size_t bytes = walk_bytes(n, max_deg, full != 0);
  *scratch_bytes = (long long)bytes;
  return bytes + 2 * kRing * sizeof(uint32_t) <= (size_t)optin ? 1 : 0;
}

// One launch of the walk. `tier` 1 walks in shared memory, 0 in `scratch`
// (gossip_walk_tier's bytes); nbr null is the full topology.
extern "C" int gossip_walk_hops(float* s, float* w, int* term, uint8_t* conv,
                                const int* nbr, const int* deg, void* scratch,
                                int max_deg, int n, int* scal, unsigned k1,
                                unsigned k2, int hops, int max_steps, int target,
                                float delta, int term_rounds, int tier,
                                int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WalkArgs a{s, w, term, conv, nbr, deg, scratch, max_deg, n, scal, k1, k2,
                   hops, max_steps, target, delta, term_rounds};
  const cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool full = nbr == nullptr;
  const size_t ring = 2 * kRing * sizeof(uint32_t);
  const size_t bytes = ring + walk_bytes(n, max_deg, full);
  if (tier)
    err = full ? launch<true, true>(a, bytes, stream) : launch<true, false>(a, bytes, stream);
  else
    err = full ? launch<false, true>(a, ring, stream) : launch<false, false>(a, ring, stream);
  return (int)err;
}
