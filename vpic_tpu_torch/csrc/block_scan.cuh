// block_scan.cuh -- exclusive prefix counts over one CUDA block, in thread
// order, built from warp ballots, shuffles and __popc.
//
// The residency kernels (fused_push3d.cu's outbox copy, merge_p.cu's keeper
// compaction) place flagged lanes in LANE ORDER: plan_exchange's stable
// sort, and so the whole lane layout, depends on that order, which an atomic
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

// The exclusive prefix sum of v over the THREADS threads of a block, in
// thread order, and the block's total in *total.  Every thread of the block
// must call it (it holds one __syncthreads); a kernel that calls it again
// first passes a __syncthreads(), since the calls share their shared words.
template <int THREADS>
__device__ __forceinline__ int block_excl_sum(int v, int* total) {
  static_assert(THREADS % 32 == 0 && THREADS <= BLOCK, "whole warps");
  constexpr int NW = THREADS / 32;
  __shared__ int wsum[NW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += u;
  }
  if (lane == 31) wsum[warp] = s;
  __syncthreads();
  int before = 0;
  int all = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int c = wsum[w];
    all += c;
    if (w < warp) before += c;
  }
  *total = all;
  return before + s - v;
}

}  // namespace vpic_scan
