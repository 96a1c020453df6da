// compact_block.cu -- stable per-block lane compaction, written by hand for
// Hopper (sm_90a).
//
// Replaces the residency prototypes' compaction kernels:
//   scripts/residency_proto.py::_compact_kernel (one (9, 4096) block),
//   scripts/residency_grid_bench.py::make(compact).kern and
//   scripts/residency_grid_bench2.py::make(variant).kern (a grid of (16, 4096)
//   blocks; their copy variants are this kernel with an all-true mask).
// Its plain PyTorch twin is vpic_tpu_torch/ops/compact.py::compact_blocks_ref.
//
// The TPU kernels find each kept lane's slot with triangular matmuls and move
// the rows with one-hot MXU dots over 2S-lane windows (S = 512), which caps how
// far a kept lane may move.  Here one CUDA block of 1024 threads walks its
// lane block in 1024-lane chunks: an exclusive count of the kept lanes from
// warp ballots and __popc (block_scan.cuh), plus the kept lanes of the chunks
// before, gives each kept lane its slot, and its thread copies the lane's
// rows there.  The block's slots past its kept count are written as zeros,
// and thread 0 writes the count.  Pure data movement: bit-exact, no window
// cap, and a -0.0 stays -0.0 (the TPU's dots turn it into +0.0).
//
// What bounds it on the H100: bytes.  Each of the R rows is read once and
// written once, the mask read once: 2 R P 4 + P x (mask bytes) B, at
// (16, 64 x 4096) with a float mask 34.6 MB, ~10 us at 3.35 TB/s.  Reads are
// coalesced, and consecutive kept lanes write consecutive addresses.  One
// block per lane block leaves SMs idle when there are fewer lane blocks than
// SMs (64 blocks on 132 SMs at the grid bench's size): simple first.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

using vpic_scan::BLOCK;

__global__ void __launch_bounds__(BLOCK)
compact_kernel(const float* __restrict__ pk, const void* __restrict__ keep,
               int keep_is_float, float* __restrict__ out,
               int* __restrict__ counts, int rows, long long ncols,
               int block) {
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * block;
  int carry = 0;  // kept lanes of the chunks before this one
  for (int c0 = 0; c0 < block; c0 += BLOCK) {  // uniform over the block
    const int lane = c0 + t;
    bool flag = false;
    if (lane < block) {
      const long long k = base + lane;
      flag = keep_is_float
                 ? static_cast<const float*>(keep)[k] != 0.0f
                 : static_cast<const bool*>(keep)[k];
    }
    int total;
    const int pos = vpic_scan::block_excl_count(flag, &total);
    if (flag) {
      const long long src = base + lane;
      const long long dst = base + carry + pos;
      for (int r = 0; r < rows; ++r)
        out[r * ncols + dst] = pk[r * ncols + src];
    }
    carry += total;
    __syncthreads();  // the next chunk's count reuses the shared words
  }
  for (int lane = t; lane < block; lane += BLOCK) {
    if (lane >= carry) {
      const long long k = base + lane;
      for (int r = 0; r < rows; ++r) out[r * ncols + k] = 0.0f;
    }
  }
  if (t == 0) counts[blockIdx.x] = carry;
}

}  // namespace

// pk and out are (rows, ncols) float32, ncols = nblocks * block; keep is
// (ncols,) bool (keep_is_float = 0) or float32 with a lane kept where it is
// not 0 (keep_is_float = 1); counts is (nblocks,) int32.  Returns a
// cudaError_t code, 0 on success.
extern "C" int compact_block(const float* pk, const void* keep,
                             int keep_is_float, float* out, int* counts,
                             int rows, long long ncols, int block,
                             int nblocks, void* stream) {
  if (nblocks <= 0) return 0;
  if (rows <= 0 || block <= 0 || (long long)block * nblocks != ncols)
    return (int)cudaErrorInvalidValue;
  compact_kernel<<<nblocks, BLOCK, 0, (cudaStream_t)stream>>>(
      pk, keep, keep_is_float, out, counts, rows, ncols, block);
  return (int)cudaGetLastError();
}

extern "C" const char* compact_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
