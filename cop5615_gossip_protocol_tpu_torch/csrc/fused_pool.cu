// Offset-pool push-sum and gossip chunks on the implicit full topology,
// for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's
// ops/fused_pool.py: make_pushsum_pool_chunk (pallas_call at :860) and
// make_gossip_pool_chunk (pallas_call at :1157). Each runs K synchronous
// rounds of the protocol on the padded [rows, 128] layout:
//
//   choice(i) = (threefry(k1, k2, (row(i) / 8) * 128 + lane(i))
//                >> 4 * (row(i) % 8)) & (P - 1)
//   inbox[j]  = sum over slots k, in order from 0.0, of send[i] * [choice(i) == k]
//               with i = j - d_k if j >= d_k else j - d_k + n   (a mod-n roll)
//
// then the absorb with the term/conv latch (push-sum) or the receipt
// count with receiver-side suppression (gossip), and a done flag that
// stops the chunk once the converged count reaches the target. Pad lanes
// (j >= n) never send and never receive.
//
// What bounds it on this card: memory traffic. The arithmetic is small
// (one 20-round Threefry per 8 nodes, a dozen float ops per node), while a
// round must at least read and write the state: s, w, term and conv are
// 16 bytes a node each way, 32 MiB a round at n_pad = 2**20. The state and
// the send planes (about 26 MiB) fit in the 50 MB L2, so most of that
// traffic is served from L2 rather than HBM.
//
// Design: the TPU kernel's doubled planes, lane rotates and straddle split
// exist because a TPU tile load needs a static shape; here a shifted read
// is just a load at a computed index, and neighbouring threads read
// neighbouring addresses, so the gather is coalesced as it stands. Each
// round is two launches that keep the state in place:
//   send   - one thread per packed word (8 nodes of one lane): draws the
//            word, writes the halved sends and the int8 choice plane
//            (gossip folds its send mask into the choice as -1);
//   absorb - one thread per node: gathers the P slot contributions,
//            absorbs, and adds its block's converged count to the round's
//            total; the last block to finish latches the done flag and
//            the executed-round count in `ctrl`.
// Every launch first reads the done flag and returns at once when it is
// set, so a chunk of K rounds is 2K launches queued with no host sync,
// after an init launch that copies the input planes into the output planes
// and seeds the done flag (csrc/chunk.cuh, which also holds the absorb
// arithmetic and the numerics).

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "threefry.cuh"

namespace {

using gossip::GossipPlanes;
using gossip::PushSumPlanes;
using gossip::block_sum;
using gossip::finish_count;
using gossip::kBlock;

constexpr int kLanes = 128;
constexpr int kPack = 8;  // nodes (rows) per packed choice word

inline int blocks_for(long long threads) {
  return (int)((threads + kBlock - 1) / kBlock);
}

__device__ __forceinline__ int mod_n_source(int j, int d, int n) {
  return j >= d ? j - d : j - d + n;
}

// ---------------------------------------------------------------- push-sum

__global__ void pushsum_send(const float* __restrict__ s,
                             const float* __restrict__ w, float* ds,
                             float* dw, int8_t* choice,
                             const long long* __restrict__ key, int n,
                             int n_words, int pool_size,
                             const int* __restrict__ ctrl) {
  if (ctrl[0]) return;
  const int wi = blockIdx.x * kBlock + threadIdx.x;
  if (wi >= n_words) return;
  const uint32_t word =
      gossip::threefry_word((uint32_t)key[0], (uint32_t)key[1], (uint32_t)wi);
  const int base = (wi / kLanes) * kPack * kLanes + wi % kLanes;
  for (int sub = 0; sub < kPack; ++sub) {
    const int j = base + sub * kLanes;
    const bool pad = j >= n;
    ds[j] = pad ? 0.0f : s[j] * 0.5f;
    dw[j] = pad ? 0.0f : w[j] * 0.5f;
    choice[j] = (int8_t)gossip::pool_slot(word, sub, pool_size);
  }
}

__global__ void pushsum_absorb(float* s, float* w, int* term, int* conv,
                               const float* __restrict__ ds,
                               const float* __restrict__ dw,
                               const int8_t* __restrict__ choice,
                               const int* __restrict__ offs, int n, int n_pad,
                               int pool_size, float delta, int term_rounds,
                               int target, int* total, unsigned* ticket,
                               int* ctrl) {
  if (ctrl[0]) return;
  const int j = blockIdx.x * kBlock + threadIdx.x;
  int c = 0;
  if (j < n_pad) {
    const bool pad = j >= n;
    float in_s = 0.0f, in_w = 0.0f;
    if (!pad) {
      for (int slot = 0; slot < pool_size; ++slot) {
        const int i = mod_n_source(j, offs[slot], n);
        const bool hit = choice[i] == slot;
        in_s = in_s + (hit ? ds[i] : 0.0f);
        in_w = in_w + (hit ? dw[i] : 0.0f);
      }
    }
    // In place: the gathers above read the send planes, never s or w.
    const PushSumPlanes st{s, w, term, conv};
    c = gossip::pushsum_absorb_node(st, st, j, pad, !pad, in_s, in_w, delta,
                                    term_rounds);
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, true);
}

// ------------------------------------------------------------------ gossip

__global__ void gossip_send(const int* __restrict__ active, int8_t* mark,
                            const long long* __restrict__ key, int n,
                            int n_words, int pool_size,
                            const int* __restrict__ ctrl) {
  if (ctrl[0]) return;
  const int wi = blockIdx.x * kBlock + threadIdx.x;
  if (wi >= n_words) return;
  const uint32_t word =
      gossip::threefry_word((uint32_t)key[0], (uint32_t)key[1], (uint32_t)wi);
  const int base = (wi / kLanes) * kPack * kLanes + wi % kLanes;
  for (int sub = 0; sub < kPack; ++sub) {
    const int j = base + sub * kLanes;
    const bool sending = j < n && active[j] != 0;
    mark[j] = (int8_t)(sending ? gossip::pool_slot(word, sub, pool_size) : -1);
  }
}

__global__ void gossip_absorb(int* count, int* active, int* conv,
                              const int8_t* __restrict__ mark,
                              const int* __restrict__ offs, int n, int n_pad,
                              int pool_size, int rumor_target, int suppress,
                              int target, int* total, unsigned* ticket,
                              int* ctrl) {
  if (ctrl[0]) return;
  const int j = blockIdx.x * kBlock + threadIdx.x;
  int c = 0;
  if (j < n_pad) {
    int inbox = 0;
    if (j < n) {
      for (int slot = 0; slot < pool_size; ++slot) {
        inbox += mark[mod_n_source(j, offs[slot], n)] == slot ? 1 : 0;
      }
    }
    const GossipPlanes st{count, active, conv};
    c = gossip::gossip_absorb_node(st, st, j, j >= n, inbox, rumor_target,
                                   suppress);
  }
  finish_count(block_sum(c), total, ticket, ctrl, target, true);
}

}  // namespace

// ------------------------------------------------------------- C interface
//
// Both entry points queue the init launch plus two launches per round on
// `stream` of CUDA device `device` and return the first launch error (a cudaError_t), 0 if none.
// Outputs and scratch are allocated by the caller: ctrl is int32[2]
// (done, rounds executed) and scratch int32[2 * (rounds + 1)] (per-round
// totals, then tickets), both zeroed; the choice plane is int8[n_pad].

extern "C" int gossip_pushsum_pool_chunk(
    const float* s0, const float* w0, const int* t0, const int* c0, float* s,
    float* w, int* term, int* conv, float* ds, float* dw, int8_t* choice,
    const long long* keys, const int* offs, int* ctrl, int* scratch, int n,
    int n_pad, int pool_size, int rounds, float delta, int term_rounds,
    int target, int device, void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  const int n_words = n_pad / kPack;
  gossip::pushsum_init<<<blocks_for(n_pad), kBlock, 0, stream>>>(
      s0, w0, t0, c0, PushSumPlanes{s, w, term, conv}, n_pad,
      totals + rounds, tickets + rounds, ctrl, target);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    pushsum_send<<<blocks_for(n_words), kBlock, 0, stream>>>(
        s, w, ds, dw, choice, keys + 2 * r, n, n_words, pool_size, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    pushsum_absorb<<<blocks_for(n_pad), kBlock, 0, stream>>>(
        s, w, term, conv, ds, dw, choice, offs + r * pool_size, n, n_pad,
        pool_size, delta, term_rounds, target, totals + r, tickets + r, ctrl);
    err = cudaGetLastError();
  }
  return (int)err;
}

extern "C" int gossip_gossip_pool_chunk(
    const int* n0, const int* a0, const int* c0, int* count, int* active,
    int* conv, int8_t* mark, const long long* keys, const int* offs,
    int* ctrl, int* scratch, int n, int n_pad, int pool_size, int rounds,
    int rumor_target, int suppress, int target, int device,
    void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  int* totals = scratch;
  unsigned* tickets = (unsigned*)(scratch + rounds + 1);
  const int n_words = n_pad / kPack;
  gossip::gossip_init<<<blocks_for(n_pad), kBlock, 0, stream>>>(
      n0, a0, c0, GossipPlanes{count, active, conv}, n_pad, totals + rounds,
      tickets + rounds, ctrl, target);
  err = cudaGetLastError();
  for (int r = 0; r < rounds && err == cudaSuccess; ++r) {
    gossip_send<<<blocks_for(n_words), kBlock, 0, stream>>>(
        active, mark, keys + 2 * r, n, n_words, pool_size, ctrl);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    gossip_absorb<<<blocks_for(n_pad), kBlock, 0, stream>>>(
        count, active, conv, mark, offs + r * pool_size, n, n_pad, pool_size,
        rumor_target, suppress, target, totals + r, tickets + r, ctrl);
    err = cudaGetLastError();
  }
  return (int)err;
}
