// imp2d/imp3d push-sum and gossip chunks under pooled long-range sampling,
// for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the JAX package:
// ops/fused_imp.py's make_pushsum_imp_chunk (pallas_call at :307) and
// make_gossip_imp_chunk (:467), and ops/fused_imp_hbm.py's
// make_pushsum_imp_hbm_chunk (:478) and make_gossip_imp_hbm_chunk (:716).
// The two pairs compute one function, split by the TPU's VMEM budget into
// a resident and a streaming tier; here one pair of launches over ping/pong
// device planes computes it at any size. Each chunk runs K synchronous
// rounds on the padded [rows, 128] pool layout:
//
//   class(i) = imp_class(i, threefry(k1, k2, i), pool slot of i in the
//              packed word threefry(ck1, ck2, choice_counter(i)))
//                                                       (csrc/imp.cuh)
//   inbox[j] = sum from 0.0 over the L lattice classes q in sorted order,
//              then the P pool slots p, of send[i] * [class(i) == id],
//              i = j - d mod n, (id, d) = (q, d_q) or (L + p, offs[p])
//
// then the absorb with the term/conv latch (push-sum) or the receipt count
// with receiver-side suppression (gossip), and the done flag. Pad lanes
// (j >= n) never send and never receive; pool sources wrap mod n across
// the pad, lattice sources never leave the grid.
//
// What bounds it on this card: memory traffic. A round must read and write
// the state (push-sum 16 bytes a node each way, gossip 12); at 16.8M nodes
// that streams from HBM every round. The lattice class sources of a block
// lie within +-g*g nodes of it and hit the L2, but each of the P pool
// classes reads the marks and sends of a window a random distance away:
// P more streams of the mark plane (and of s and w, for push-sum) that the
// L2 serves only once per window. The arithmetic is two 20-round Threefry
// hashes per 8 nodes' choice word and per node, the direction select and
// one compare per class a node.
//
// Design: as csrc/fused_stencil.cu, each round is a mark launch and an
// absorb launch, with the init and finish launches of csrc/chunk.cuh:
//   mark   - one thread per packed choice word (8 nodes of one lane, 128
//            rows apart): hashes the choice word once for its 8 nodes and
//            each node's slot word, and writes each node's class id (int8,
//            -1 for no send; gossip skips inactive nodes);
//   absorb - each receiver gathers, per class, the halved send of its
//            class source whose mark is that class, from the round's
//            current planes, and writes the absorbed state to the other.
// The TPU kernels' class-column planes, doubled planes, windows and d/d+Z
// blends exist because a TPU tile load needs a static shape; here the
// lattice is arithmetic (csrc/stencil.cuh), a shifted read is a load at a
// computed index, and the round's pool offsets go in by value, one launch
// per round, from the host-drawn stream. Class ids, not displacements, key
// the delivery, so a pool offset equal to a lattice displacement (or to
// another slot's) delivers each send once.
//
// Numerics: see csrc/chunk.cuh; the halve happens before the class sums,
// which run from 0.0 in class order, as the chunked engine's
// halve_and_send and deliver_imp_pool do, so push-sum is bitwise the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "imp.cuh"

namespace {

using gossip::Classes;
using gossip::GossipPlanes;
using gossip::PushSumPlanes;
using gossip::block_sum;
using gossip::finish_count;
using gossip::grid_for;
using gossip::kBlock;

constexpr int kMaxPool = 16;  // the packed-choice limit: 4 bits a node

// The round's pool displacements, passed by value.
struct Pool {
  int count;
  int d[kMaxPool];
};

// Class ids of one round. `active_a`/`active_b` are the gossip active
// planes (the current one by the round parity); push-sum passes nullptr
// and every real node sends.
__global__ void imp_mark(int8_t* mark, const int* __restrict__ active_a,
                         const int* __restrict__ active_b,
                         const long long* __restrict__ key,
                         const long long* __restrict__ ckey, gossip::Lattice L,
                         Classes lattice, int pool_size, int n_words,
                         const int* __restrict__ ctrl) {
  if (ctrl[0]) return;
  const int* active = (ctrl[1] & 1) ? active_b : active_a;
  const uint32_t k1 = (uint32_t)key[0], k2 = (uint32_t)key[1];
  const uint32_t c1 = (uint32_t)ckey[0], c2 = (uint32_t)ckey[1];
  for (int wi = blockIdx.x * kBlock + threadIdx.x; wi < n_words;
       wi += gridDim.x * kBlock) {
    const uint32_t cword = gossip::threefry_word(c1, c2, (uint32_t)wi);
    const int base = (wi / gossip::kChoiceLanes) * gossip::kChoicePack *
                         gossip::kChoiceLanes +
                     wi % gossip::kChoiceLanes;
    for (int sub = 0; sub < gossip::kChoicePack; ++sub) {
      const int j = base + sub * gossip::kChoiceLanes;
      int8_t m = -1;
      if (j < L.n && (active == nullptr || active[j] != 0)) {
        const uint32_t bits = gossip::threefry_word(k1, k2, (uint32_t)j);
        m = (int8_t)gossip::imp_class(L, lattice, j, bits,
                                      gossip::pool_slot(cword, sub, pool_size));
      }
      mark[j] = m;
    }
  }
}

// Adds the halved send of class source i to (in_s, in_w) if its mark is
// class `id`, else 0.0: the chunked engine's masked roll, term by term.
__device__ __forceinline__ void gather_send(const PushSumPlanes& cur,
                                            const int8_t* __restrict__ mark,
                                            int i, int id, float& in_s,
                                            float& in_w) {
  float vs = 0.0f, vw = 0.0f;
  if (mark[i] == id) {
    vs = cur.s[i] * 0.5f;
    vw = cur.w[i] * 0.5f;
  }
  in_s = in_s + vs;
  in_w = in_w + vw;
}

__global__ void pushsum_absorb(PushSumPlanes a, PushSumPlanes b,
                               const int8_t* __restrict__ mark,
                               Classes lattice, Pool pool, int n, int n_pad,
                               float delta, int term_rounds, int target,
                               int* total, unsigned* ticket, int* ctrl) {
  if (ctrl[0]) return;
  const bool odd = ctrl[1] & 1;
  const PushSumPlanes cur = odd ? b : a;
  const PushSumPlanes nxt = odd ? a : b;
  int c = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool pad = j >= n;
    float in_s = 0.0f, in_w = 0.0f;
    if (!pad) {
      // Unrolled to the caps, so the class lists stay in registers and
      // every class's mark load is in flight at once.
#pragma unroll
      for (int q = 0; q < gossip::kMaxDirs; ++q)
        if (q < lattice.count)
          gather_send(cur, mark, gossip::class_source(j, lattice.d[q], n), q,
                      in_s, in_w);
#pragma unroll
      for (int p = 0; p < kMaxPool; ++p)
        if (p < pool.count)
          gather_send(cur, mark, gossip::class_source(j, pool.d[p], n),
                      lattice.count + p, in_s, in_w);
    }
    // mark[j] < 0 on pad lanes: those keep their mass.
    c += gossip::pushsum_absorb_node(cur, nxt, j, pad, mark[j] >= 0, in_s,
                                     in_w, delta, term_rounds);
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, true);
}

__global__ void gossip_absorb(GossipPlanes a, GossipPlanes b,
                              const int8_t* __restrict__ mark,
                              Classes lattice, Pool pool, int n, int n_pad,
                              int rumor_target, int suppress, int target,
                              int* total, unsigned* ticket, int* ctrl) {
  if (ctrl[0]) return;
  const bool odd = ctrl[1] & 1;
  const GossipPlanes cur = odd ? b : a;
  const GossipPlanes nxt = odd ? a : b;
  int c = 0;
  for (int j = blockIdx.x * kBlock + threadIdx.x; j < n_pad;
       j += gridDim.x * kBlock) {
    const bool pad = j >= n;
    int inbox = 0;
    if (!pad) {
#pragma unroll
      for (int q = 0; q < gossip::kMaxDirs; ++q)
        if (q < lattice.count)
          inbox += mark[gossip::class_source(j, lattice.d[q], n)] == q ? 1 : 0;
#pragma unroll
      for (int p = 0; p < kMaxPool; ++p)
        if (p < pool.count)
          inbox += mark[gossip::class_source(j, pool.d[p], n)] ==
                           lattice.count + p
                       ? 1
                       : 0;
    }
    c += gossip::gossip_absorb_node(cur, nxt, j, pad, inbox, rumor_target,
                                    suppress);
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, true);
}

// Lattice and lattice classes from the C arguments; false if they are out
// of range for the kernels.
bool setup(int kind, int n, int n_pad, const int* classes, int n_classes,
           int pool_size, gossip::Lattice* L, Classes* lattice) {
  if ((kind != gossip::kGrid2d && kind != gossip::kGrid3d) || n < 2 ||
      n > n_pad || n_pad % (gossip::kChoicePack * gossip::kChoiceLanes) != 0 ||
      n_classes < 1 || n_classes > gossip::kMaxDirs || pool_size < 2 ||
      pool_size > kMaxPool || (pool_size & (pool_size - 1)) != 0)
    return false;
  *L = gossip::make_lattice(kind, n, 0);
  lattice->count = n_classes;
  for (int k = 0; k < gossip::kMaxClasses; ++k)
    lattice->d[k] = k < n_classes ? classes[k] : 0;
  for (int k = 0; k < n_classes; ++k)
    if (lattice->d[k] < 1 || lattice->d[k] >= n) return false;
  return true;
}

// Round r's pool from the host stream `offs` [rounds, pool_size]; false if
// an offset is outside [1, n-1].
bool round_pool(const int* offs, int r, int pool_size, int n, Pool* pool) {
  pool->count = pool_size;
  for (int p = 0; p < kMaxPool; ++p) {
    pool->d[p] = p < pool_size ? offs[r * pool_size + p] : 0;
    if (p < pool_size && (pool->d[p] < 1 || pool->d[p] >= n)) return false;
  }
  return true;
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Both entry points queue the init launch, two launches per round and the
// finish launch on `stream` of CUDA device `device`, and return the first
// launch error (a cudaError_t), 0 if none. Outputs and scratch are
// allocated by the caller: the A planes receive the result, the B planes
// are the other half of the ping/pong pair; mark is int8[n_pad]; ctrl and
// scratch as csrc/chunk.cuh says. `keys` and `ckeys` are device arrays of
// the per-round key pairs; `offs` ([rounds, pool_size]) and `classes` (the
// n_classes sorted lattice classes) are host arrays, read here.

extern "C" int gossip_pushsum_imp_chunk(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* s_b, float* w_b, int* term_b,
    int* conv_b, int8_t* mark, const long long* keys, const long long* ckeys,
    const int* offs, int* ctrl, int* scratch, const int* classes,
    int n_classes, int kind, int n, int n_pad, int rounds, int pool_size,
    float delta, int term_rounds, int target, int device, void* stream_ptr) {
  gossip::Lattice L;
  Classes lattice;
  Pool pool;
  if (!setup(kind, n, n_pad, classes, n_classes, pool_size, &L, &lattice))
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < rounds; ++r)
    if (!round_pool(offs, r, pool_size, n, &pool))
      return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  const int n_words = n_pad / gossip::kChoicePack;
  const PushSumPlanes a{s, w, term, conv};
  const PushSumPlanes b{s_b, w_b, term_b, conv_b};
  const int grid_init = grid_for(gossip::pushsum_init, n_pad, device);
  const int grid_mark = grid_for(imp_mark, n_words, device);
  const int grid_absorb = grid_for(pushsum_absorb, n_pad, device);
  const int grid_finish = grid_for(gossip::pushsum_finish, n_pad, device);
  gossip::pushsum_init<<<grid_init, kBlock, 0, stream>>>(
      s0, w0, t0, c0, a, n_pad, totals + rounds, tickets + rounds, ctrl,
      target);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    round_pool(offs, r, pool_size, n, &pool);
    imp_mark<<<grid_mark, kBlock, 0, stream>>>(
        mark, nullptr, nullptr, keys + 2 * r, ckeys + 2 * r, L, lattice,
        pool_size, n_words, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    pushsum_absorb<<<grid_absorb, kBlock, 0, stream>>>(
        a, b, mark, lattice, pool, n, n_pad, delta, term_rounds, target,
        totals + r, tickets + r, ctrl);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  gossip::pushsum_finish<<<grid_finish, kBlock, 0, stream>>>(a, b, n_pad,
                                                             ctrl);
  return (int)cudaGetLastError();
}

extern "C" int gossip_gossip_imp_chunk(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int* count_b, int* active_b, int* conv_b, int8_t* mark,
    const long long* keys, const long long* ckeys, const int* offs, int* ctrl,
    int* scratch, const int* classes, int n_classes, int kind, int n,
    int n_pad, int rounds, int pool_size, int rumor_target, int suppress,
    int target, int device, void* stream_ptr) {
  gossip::Lattice L;
  Classes lattice;
  Pool pool;
  if (!setup(kind, n, n_pad, classes, n_classes, pool_size, &L, &lattice))
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < rounds; ++r)
    if (!round_pool(offs, r, pool_size, n, &pool))
      return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  const int n_words = n_pad / gossip::kChoicePack;
  const GossipPlanes a{count, active, conv};
  const GossipPlanes b{count_b, active_b, conv_b};
  const int grid_init = grid_for(gossip::gossip_init, n_pad, device);
  const int grid_mark = grid_for(imp_mark, n_words, device);
  const int grid_absorb = grid_for(gossip_absorb, n_pad, device);
  const int grid_finish = grid_for(gossip::gossip_finish, n_pad, device);
  gossip::gossip_init<<<grid_init, kBlock, 0, stream>>>(
      n0, a0, c0, a, n_pad, totals + rounds, tickets + rounds, ctrl, target);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    round_pool(offs, r, pool_size, n, &pool);
    imp_mark<<<grid_mark, kBlock, 0, stream>>>(
        mark, active, active_b, keys + 2 * r, ckeys + 2 * r, L, lattice,
        pool_size, n_words, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    gossip_absorb<<<grid_absorb, kBlock, 0, stream>>>(
        a, b, mark, lattice, pool, n, n_pad, rumor_target, suppress, target,
        totals + r, tickets + r, ctrl);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  gossip::gossip_finish<<<grid_finish, kBlock, 0, stream>>>(a, b, n_pad, ctrl);
  return (int)cudaGetLastError();
}
