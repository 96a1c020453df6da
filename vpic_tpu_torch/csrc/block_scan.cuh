// block_scan.cuh -- an exclusive prefix count over one 1024-thread block, in
// thread order, built from warp ballots and __popc.
//
// The residency kernels (fused_push3d.cu's outbox copy, merge_p.cu's keeper
// compaction, compact_block.cu) place flagged lanes in LANE ORDER: plan_exchange's stable sort,
// and so the whole lane layout, depends on that order, which an atomic
// counter would not keep.

#pragma once

#include <cuda_runtime.h>

namespace vpic_scan {

constexpr int BLOCK = 1024;
constexpr int WARPS = BLOCK / 32;

// Returns the number of threads below this one whose flag is set, and the
// block's total in *total.  Every thread of the block must call it (it holds
// two __syncthreads); a kernel that calls it again first passes a
// __syncthreads(), since the calls share their shared words.
__device__ __forceinline__ int block_excl_count(bool flag, int* total) {
  __shared__ int woff[WARPS + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) woff[warp] = __popc(bal);
  __syncthreads();
  if (warp == 0) {
    const int c = woff[lane];
    int s = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += v;
    }
    woff[lane] = s - c;
    if (lane == 31) woff[WARPS] = s;
  }
  __syncthreads();
  *total = woff[WARPS];
  return woff[warp] + __popc(bal & ((1u << lane) - 1u));
}

}  // namespace vpic_scan
