// Scatter delivery's push-sum and gossip rounds on flat [n] planes, for
// Hopper (sm_90a): the chunked engine's round on the implicit full
// topology and on explicit neighbour tables (imp2d/imp3d along their static
// extra edge, any lattice under delivery="scatter").
//
// Replaces no Pallas kernel: the JAX package runs this round as XLA ops
// (models/runner.py targets_and_gate, models/pushsum.py round_from_targets)
// with an XLA scatter-add for delivery (ops/delivery.py:22, deliver). Each
// sender i draws its target t(i) from the round's Threefry word at flat
// position i (csrc/scatter.cuh), and each node j adds its senders' values
// in ascending sender index, i1 < i2 < ... the senders with t = j:
//
//   gossip     inbox[j] = 0 + 1 + 1 + ...                  (int32, any order)
//   push-sum   s'[j] = s_keep[j] + s(i1) / 2 + s(i2) / 2 + ...
//              in_w[j] = 0 + w(i1) / 2 + w(i2) / 2 + ...,  w'[j] = w_keep[j] + in_w[j]
//
// then the term/conv latch (push-sum, received = in_w > 0) or the receipt
// count with receiver-side suppression (gossip), and a done flag once the
// converged count reaches the target. That is the op order of the JAX
// package's jitted round on the CPU, whose scatter-add runs in source
// order and where XLA folds s_keep + deliver(s) into one scatter-add onto
// s_keep (the w inbox it keeps, for `received`); an atomic float add would
// take another order on every run.
//
// What bounds it on this card: memory traffic, with gathers that land
// anywhere. At 1M nodes a push-sum round reads the state (s, w, term, conv:
// 13 bytes a node) and writes it back, and moves each send through the
// bucket planes (target, count, fill, offset, staged index and halves);
// most of it stays in the 50 MB L2 at 1M.
//
// Design, a simple correct form: a chunk is one host call that queues its
// rounds with no host sync. Gossip's round is two launches: the informed
// senders add 1 to their target's inbox with an int32 atomic (exact in any
// order), then every node absorbs its inbox (and zeroes it for the next
// round) and counts the converged nodes. Push-sum's round is five: the
// senders draw their targets and count each bucket; a hand-written
// exclusive scan of the counts (tiles of 1024, then the tile sums in one
// block); the senders place (index, s / 2, w / 2) into their bucket at an
// atomic cursor; then every target sorts its bucket by sender index, adds
// it up in that order and absorbs (scatter.cuh pushsum_node), and counts
// the converged nodes. The state is updated in place: the sends a node
// absorbs were staged from the round-start planes by the launch before.
// Every launch first reads the status word (int32 [2]: rounds executed,
// done) and returns at once when done is set, so a round after
// convergence is a no-op; the absorb's last block takes the verdict,
// counts the round and resets its converged count and ticket. Degree-0
// nodes do not send (their value is 0 and would add +0.0). Gossip's absorb
// is csrc/chunk.cuh's; the numerics are its too (no fast math,
// -fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "scatter.cuh"
#include "threefry.cuh"

namespace {

using gossip::block_sum;
using gossip::grid_for;
using gossip::kBlock;
using gossip::threefry_word;
using gossip::scatter::pushsum_node;
using gossip::scatter::target_explicit;
using gossip::scatter::target_full;

constexpr int kScanItems = 4;
constexpr int kScanTile = kBlock * kScanItems;  // counts a scan block covers

struct Graph {
  const int* nbr;  // [n, max_deg] padded neighbour table; null on full
  const int* deg;  // [n] degrees; null on full
  int max_deg;
  int n;
};

// Sender i's target under the round key, or -1 when i does not send.
__device__ __forceinline__ int target_of(const Graph& g, uint32_t k1,
                                         uint32_t k2, int i) {
  if (g.nbr == nullptr) return target_full(threefry_word(k1, k2, (uint32_t)i), i, g.n);
  const int d = g.deg[i];
  if (d <= 0) return -1;
  return target_explicit(threefry_word(k1, k2, (uint32_t)i),
                         g.nbr + (long long)i * g.max_deg, d);
}

__device__ __forceinline__ bool sends(const Graph& g, int j) {
  return g.nbr == nullptr || g.deg[j] > 0;
}

// Adds the block's converged count to acc[0]; the last block of the grid
// to take a ticket (acc[1]) counts the round, sets done from the grand
// total and resets both words for the next round. Every other block read
// the status before it took its ticket, so the write races with no reader.
__device__ void finish_round(int count, int* acc, int* status, int target) {
  const int total = block_sum(count);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    atomicAdd(&acc[0], total);
    __threadfence();
    last = atomicAdd((unsigned*)&acc[1], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    const int grand = atomicAdd(&acc[0], 0);
    acc[0] = 0;
    acc[1] = 0;
    status[0] += 1;
    status[1] = grand >= target ? 1 : 0;
  }
}

// Exclusive prefix of v over the block; total gets the block's sum.
__device__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_tot[kBlock / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kBlock / 32 ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kBlock / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_tot[warp - 1] : 0;
  total = warp_tot[kBlock / 32 - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return before + x - v;
}

// ------------------------------------------------------------------ gossip

__global__ void gossip_send(Graph g, const uint8_t* __restrict__ active,
                            int* __restrict__ inbox, uint32_t k1, uint32_t k2,
                            const int* status) {
  if (status[1]) return;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < g.n;
       i += gridDim.x * blockDim.x) {
    if (!active[i]) continue;
    const int t = target_of(g, k1, k2, i);
    if (t >= 0) atomicAdd(&inbox[t], 1);
  }
}

__global__ void gossip_absorb_pass(int* __restrict__ count,
                                   uint8_t* __restrict__ active,
                                   uint8_t* __restrict__ conv,
                                   int* __restrict__ inbox, int n,
                                   int rumor_target, int suppress, int target,
                                   int* acc, int* status) {
  if (status[1]) return;
  int c = 0;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const int in = inbox[j];
    inbox[j] = 0;
    int cnt, act;
    const int cv = gossip::gossip_absorb(
        [&] { return (int)conv[j]; }, [&] { return count[j]; },
        [&] { return (int)active[j]; }, false, in, rumor_target, suppress, cnt,
        act);
    count[j] = cnt;
    active[j] = (uint8_t)act;
    conv[j] = (uint8_t)cv;
    c += cv;
  }
  finish_round(c, acc, status, target);
}

// ---------------------------------------------------------------- push-sum

__global__ void pushsum_count(Graph g, int* __restrict__ tgt,
                              int* __restrict__ cnt, uint32_t k1, uint32_t k2,
                              const int* status) {
  if (status[1]) return;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < g.n;
       i += gridDim.x * blockDim.x) {
    const int t = target_of(g, k1, k2, i);
    tgt[i] = t;
    if (t >= 0) atomicAdd(&cnt[t], 1);
  }
}

// Tile b's exclusive prefix of the counts into offs, its total into
// tile_sum[b]; one block a tile of kScanTile counts.
__global__ void scan_tiles(const int* __restrict__ cnt, int* __restrict__ offs,
                           int* __restrict__ tile_sum, int n, const int* status) {
  if (status[1]) return;
  const int base = blockIdx.x * kScanTile + threadIdx.x * kScanItems;
  int v[kScanItems];
  int run = 0;
  for (int q = 0; q < kScanItems; ++q) {
    v[q] = base + q < n ? cnt[base + q] : 0;
    run += v[q];
  }
  int total;
  int at = block_exclusive_scan(run, total);
  for (int q = 0; q < kScanItems; ++q) {
    if (base + q < n) offs[base + q] = at;
    at += v[q];
  }
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

// The tile totals' exclusive prefix, in place, by one block.
__global__ void scan_top(int* tile_sum, int tiles, const int* status) {
  if (status[1]) return;
  int carry = 0;
  for (int base0 = 0; base0 < tiles; base0 += kScanTile) {
    const int base = base0 + threadIdx.x * kScanItems;
    int v[kScanItems];
    int run = 0;
    for (int q = 0; q < kScanItems; ++q) {
      v[q] = base + q < tiles ? tile_sum[base + q] : 0;
      run += v[q];
    }
    int total;
    int at = carry + block_exclusive_scan(run, total);
    for (int q = 0; q < kScanItems; ++q) {
      if (base + q < tiles) tile_sum[base + q] = at;
      at += v[q];
    }
    carry += total;
  }
}

__device__ __forceinline__ int bucket_start(const int* offs, const int* tile_sum,
                                            int t) {
  return offs[t] + tile_sum[t / kScanTile];
}

// Each sender stages (its index, s / 2, w / 2) in its target's bucket.
__global__ void pushsum_place(int n, const int* __restrict__ tgt,
                              const int* __restrict__ offs,
                              const int* __restrict__ tile_sum,
                              int* __restrict__ fill, const float* __restrict__ s,
                              const float* __restrict__ w, int* __restrict__ idx,
                              float* __restrict__ vs, float* __restrict__ vw,
                              const int* status) {
  if (status[1]) return;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int t = tgt[i];
    if (t < 0) continue;
    const int pos = bucket_start(offs, tile_sum, t) + atomicAdd(&fill[t], 1);
    idx[pos] = i;
    vs[pos] = s[i] * 0.5f;
    vw[pos] = w[i] * 0.5f;
  }
}

// Every node sums its bucket in sender order and absorbs, in place; it
// zeroes its count and fill for the next round.
__global__ void pushsum_absorb_pass(Graph g, float* __restrict__ s,
                                    float* __restrict__ w, int* __restrict__ term,
                                    uint8_t* __restrict__ conv,
                                    int* __restrict__ cnt, int* __restrict__ fill,
                                    const int* __restrict__ offs,
                                    const int* __restrict__ tile_sum,
                                    int* __restrict__ idx, float* __restrict__ vs,
                                    float* __restrict__ vw, float delta,
                                    int term_rounds, int target, int* acc,
                                    int* status) {
  if (status[1]) return;
  int c = 0;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < g.n;
       j += gridDim.x * blockDim.x) {
    const int k = cnt[j];
    const int b = k > 0 ? bucket_start(offs, tile_sum, j) : 0;
    if (k > 0) {
      cnt[j] = 0;
      fill[j] = 0;
    }
    float s_new, w_new;
    int t_new;
    const int cv = pushsum_node(s[j], w[j], term[j], conv[j] != 0, sends(g, j),
                                idx + b, vs + b, vw + b, k, delta, term_rounds,
                                s_new, w_new, t_new);
    s[j] = s_new;
    w[j] = w_new;
    term[j] = t_new;
    conv[j] = (uint8_t)cv;
    c += cv;
  }
  finish_round(c, acc, status, target);
}

}  // namespace

// The rounds of one chunk, queued on `stream` with no host sync: round r
// under the fold_in key (keys[2r], keys[2r + 1]), read here on the host.
// The state planes are updated in place; status is int32 [2] (rounds
// executed, done); the scratch words cnt, fill and acc must be zero and
// are left zero.
extern "C" int gossip_pushsum_scatter_chunk(
    float* s, float* w, int* term, uint8_t* conv, const int* nbr, const int* deg,
    int max_deg, int n, int* tgt, int* cnt, int* fill, int* offs, int* tile_sum,
    int* idx, float* vs, float* vw, int* acc, int* status, const long long* keys,
    int rounds, float delta, int term_rounds, int target, int device,
    void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Graph g{nbr, deg, max_deg, n};
  const int tiles = (n + kScanTile - 1) / kScanTile;
  const int g_count = grid_for(pushsum_count, n, device);
  const int g_place = grid_for(pushsum_place, n, device);
  const int g_absorb = grid_for(pushsum_absorb_pass, n, device);
  for (int r = 0; r < rounds; ++r) {
    const uint32_t k1 = (uint32_t)keys[2 * r], k2 = (uint32_t)keys[2 * r + 1];
    pushsum_count<<<g_count, kBlock, 0, stream>>>(g, tgt, cnt, k1, k2, status);
    scan_tiles<<<tiles, kBlock, 0, stream>>>(cnt, offs, tile_sum, n, status);
    scan_top<<<1, kBlock, 0, stream>>>(tile_sum, tiles, status);
    pushsum_place<<<g_place, kBlock, 0, stream>>>(n, tgt, offs, tile_sum, fill,
                                                  s, w, idx, vs, vw, status);
    pushsum_absorb_pass<<<g_absorb, kBlock, 0, stream>>>(
        g, s, w, term, conv, cnt, fill, offs, tile_sum, idx, vs, vw, delta,
        term_rounds, target, acc, status);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" int gossip_gossip_scatter_chunk(
    int* count, uint8_t* active, uint8_t* conv, const int* nbr, const int* deg,
    int max_deg, int n, int* inbox, int* acc, int* status, const long long* keys,
    int rounds, int rumor_target, int suppress, int target, int device,
    void* stream_ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const Graph g{nbr, deg, max_deg, n};
  const int g_send = grid_for(gossip_send, n, device);
  const int g_absorb = grid_for(gossip_absorb_pass, n, device);
  for (int r = 0; r < rounds; ++r) {
    const uint32_t k1 = (uint32_t)keys[2 * r], k2 = (uint32_t)keys[2 * r + 1];
    gossip_send<<<g_send, kBlock, 0, stream>>>(g, active, inbox, k1, k2, status);
    gossip_absorb_pass<<<g_absorb, kBlock, 0, stream>>>(
        count, active, conv, inbox, n, rumor_target, suppress, target, acc,
        status);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
