// Clock counters of the chain kernels' counted instantiations
// (fm_chain_tile_counted, am_chain_tile_counted: the chunked PFB front at
// bf16x3), launched in place of the plain ones where tracing counts
// (gsdr_tpu_torch/utils/profiling.py, COUNTERS).
//
// A counted block keeps its counters in shared memory, one slot a warp:
// lane 0 of each warp adds its warp's SM clocks (clock64) into its own
// slot, an interval as -start at its start and +end at its end, so that no
// register holds a stamp across what it times and no two warps contend
// for a word; at the block's end thread 0 sums the slots and adds them
// into the kernel's int64 buffer on the device (the wrapper's;
// kernels/chain.py CHAIN_CLOCKS names its slots), one atomic a counter.
// The plain instantiations take none of this: every use is under
// `if constexpr`.

#pragma once

#include <cuda_runtime.h>

namespace gsdr {
namespace clocks {

// The slots of a counted kernel's buffer, in kernels/chain.py's order
enum Counter : int {
  kLaunches,       // 1 a launch, from block 0
  kBlocks,         // 1 a block
  kBlock,          // a block's start to its end (thread 0)
  kFront,          // the front call (thread 0)
  kConsumerFront,  // the consumer warps' own front (lane 0 of each)
  kFullWait,       // consumers in named_sync(kBarFull): a chunk's fold
  kProducerFront,  // the producer warps' own front
  kFreeWait,       // producers in named_sync(kBarFree): a free A tile
  kStageWait,      // producers in cp_async_wait<0>: their staging
  kPollClocks,     // the look-back's poll loop: the block's longest thread
  kPolls,          // the poll loop's polls, every thread's
  kCounters
};

constexpr int kWarps = 16;                  // a block's warps, at most
constexpr int kSlots = kCounters * kWarps;  // a block's shared words

__device__ __forceinline__ unsigned long long now() {
  return (unsigned long long)clock64();
}

// Counter k's slot of this thread's warp (thread 0's: warp 0's)
__device__ __forceinline__ unsigned long long& slot(unsigned long long* clk,
                                                    int k) {
  return clk[k * kWarps + (threadIdx.x >> 5)];
}

// An interval of warp time in counter k: lane 0 adds -start at its start
// and +end at its end
__device__ __forceinline__ void warp_open(unsigned long long* clk, int k) {
  if ((threadIdx.x & 31) == 0) slot(clk, k) -= now();
}

__device__ __forceinline__ void warp_close(unsigned long long* clk, int k) {
  if ((threadIdx.x & 31) == 0) slot(clk, k) += now();
}

// The same for thread 0 alone (the block's own counters)
__device__ __forceinline__ void block_open(unsigned long long* clk, int k) {
  if (threadIdx.x == 0) slot(clk, k) -= now();
}

__device__ __forceinline__ void block_close(unsigned long long* clk, int k) {
  if (threadIdx.x == 0) slot(clk, k) += now();
}

// The block's start: its slots zeroed and its clock started, before any
// warp adds to them
__device__ __forceinline__ void block_start(unsigned long long* clk) {
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) clk[i] = 0;
  __syncthreads();
  block_open(clk, kBlock);
}

// The block's end, once every thread is done: its slots summed and added
// into the kernel's buffer `out`
__device__ __forceinline__ void block_end(unsigned long long* clk,
                                          unsigned long long* out) {
  __syncthreads();
  if (threadIdx.x == 0) {
    block_close(clk, kBlock);
    clk[kBlocks * kWarps] = 1;
    clk[kLaunches * kWarps] = blockIdx.x == 0 && blockIdx.y == 0;
    for (int k = 0; k < kCounters; ++k) {
      unsigned long long sum = 0;
      for (int w = 0; w < kWarps; ++w) sum += clk[k * kWarps + w];
      if (sum != 0) atomicAdd(out + k, sum);
    }
  }
}

}  // namespace clocks
}  // namespace gsdr
