// What the persistent chunk kernels of csrc/fused_resident.cu and
// csrc/fused_pool.cu share: the per-round grid barrier, the grid of the
// cooperative launch and the zeroing of a chunk's control words.
//
// A persistent kernel runs every round of a chunk in one cooperative
// launch, one pass and one barrier a round. The barrier is one 64-bit word
// a round in the chunk's scratch (csrc/stencil.cuh barrier_arrival): each
// block adds its arrival (high 32 bits) and its converged count (low 32
// bits) in one atomic after a fence, then polls with acquire loads until
// the arrivals reach gridDim.x; every block then reads the same total and
// makes the same choice: stop at the target or at the cap, else go on. No
// block leaves the round loop alone, so no barrier waits on a block that
// has left, and the per-round words need no reset. It is written here
// rather than taken from cooperative_groups, whose grid sync may need
// relocatable device code and so other build flags than the rest of the
// port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk.cuh"
#include "stencil.cuh"

namespace gossip {

// The barrier of one round (or of the prologue) on its own 64-bit word:
// adds this block's arrival and converged count (valid in thread 0), waits
// for every block's, and returns the grid's total to every thread. Every
// thread's earlier writes are visible to every thread of the grid after it
// returns. The order is cooperative_groups' grid sync on the arrival side
// (block barrier, then thread 0's fence, then the add) and CUTLASS's
// GenericBarrier on the waiting side (acquire polls, then the block
// barrier). A release-qualified add in place of the fence and add is not
// enough: some reads of the next pass then saw the round's old values.
// The short sleep between polls keeps the waiting blocks' loads off the
// word's L2 line while the others arrive.
__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* word) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(word) : "memory");
  return v;
}

__device__ __forceinline__ int round_barrier(unsigned long long* word,
                                             int block_count) {
  __shared__ int total;
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long add = gossip::barrier_arrival(block_count);
    __threadfence();
    unsigned long long seen = atomicAdd(word, add) + add;
    while (gossip::barrier_arrivals(seen) < gridDim.x) {
      __nanosleep(20);
      seen = load_acquire(word);
    }
    total = gossip::barrier_total(seen);
  }
  __syncthreads();
  return total;
}

// Blocks of the persistent launch of `kernel` over `work` items, one
// thread an item: every block the SMs hold at once, at most one per 256
// items. The capacity is asked once a device (`cache`, one int a device,
// one cache a kernel) and, unlike grid_for, a failed query is returned as
// an error, and so is a card without cooperative launch.
template <typename Kernel>
cudaError_t cooperative_grid(Kernel kernel, int work, int device, int* cache,
                             int* grid) {
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBlock, 0);
    if (err != cudaSuccess) return err;
    if (sms <= 0 || per_sm <= 0) return cudaErrorCooperativeLaunchTooLarge;
    cache[device] = sms * per_sm;
  }
  const long long want = ((long long)work + kBlock - 1) / kBlock;
  *grid = (int)(want < cache[device] ? (want > 0 ? want : 1) : cache[device]);
  return cudaSuccess;
}

// Zeroes a chunk's control words: ctrl (int32[2]) and the 8 * (rounds + 2)
// bytes of scratch behind it, in one memset.
inline cudaError_t zero_control(int* ctrl, int rounds, cudaStream_t stream) {
  return cudaMemsetAsync(ctrl, 0, 8 * ((size_t)rounds + 3), stream);
}

}  // namespace gossip
