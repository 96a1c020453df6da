// compact_block.cu -- stable per-block lane compaction, and the block copy,
// written by hand for Hopper (sm_90a).
//
// Replaces the residency prototypes' compaction kernels:
//   scripts/residency_proto.py::_compact_kernel (one (9, 4096) block),
//   scripts/residency_grid_bench.py::make(compact).kern and
//   scripts/residency_grid_bench2.py::make(variant).kern (a grid of (16, 4096)
//   blocks); their copy variants, make(False) and make("copy"), are
//   block_copy_kernel.
// Its plain PyTorch twin is vpic_tpu_torch/ops/compact.py::compact_blocks_ref.
//
// The TPU kernels find each kept lane's slot with triangular matmuls and move
// the rows with one-hot MXU dots over 2S-lane windows (S = 512), which caps how
// far a kept lane may move.  Here compact_kernel's CUDA block (b, c, g) serves
// lane block b, its 1024-lane chunk c and row group g, one lane a thread, and
// finds its lanes' slots by itself, with no second launch and no wait on
// another block:
//   * it reads the whole lane block's mask, 4 lanes a thread per 16-byte
//     (float) or 4-byte (bool) load, 1024 quads a round (16 KB of float for
//     4096 lanes, read by every CUDA block of the lane block, so from L2),
//     scans the quads' kept counts over the CUDA block (warp shuffles, one
//     shared word a warp) and keeps its own chunk's quad offsets and masks in
//     shared memory; the later chunks are read for the block's count, which
//     the zeros need;
//   * each thread loads its lane's values in the first EARLY_ROWS rows of its
//     group before the mask and the scan, so those loads' latency overlaps
//     them, and the rest (up to ROWS in all) right after, before any store
//     (more would keep too many registers live through the scan, at 32 a
//     thread for 2 resident blocks an SM); a kept lane's values are then
//     stored at its slot, and a thread whose lane, as an output slot, lies
//     past the block's count writes the zeros there;
//   * block (b, 0, 0) writes counts[b].
// Lane order is the stable one, as before.  Pure data movement: bit-exact, no
// window cap, and a -0.0 stays -0.0 (the TPU's dots turn it into +0.0).
// ops/compact.compact_plan picks the rows per group: the most (up to
// MAX_ROWS) that keep the grid at two waves of the SMs.  Each CUDA block pays
// a fixed chain (mask load, three barriers, row loads) once, so fewer and
// fuller blocks are faster: 8 rows a thread took 0.0127 ms at (16, 64 x 4096)
// against 4 rows' 0.0145-0.0149, while a 1-byte mask in place of the float
// one moved nothing.  Groups of at most 4 rows launch the ROWS = 4 build,
// which is 0.0005 ms faster than the 8-row one at (9, 4096) (H100, PERF.md).
//
// block_copy_kernel is the copy (keep=None): 16-byte loads and stores over the
// whole (R, P) array, COPY_UNROLL a thread, all loaded before any is stored,
// and counts[b] = block.  No mask, no scan: the TPU's make(False) is
// opk_ref[:, :] = pk.
//
// What bounds them on the H100: bytes.  Each of the R rows is read once and
// written once, the mask read once from HBM: 2 R P 4 + P x (mask bytes) B, at
// (16, 64 x 4096) with a float mask 34.6 MB, ~10 us at 3.35 TB/s; the copy
// 33.6 MB, ~10 us.  Reads are coalesced, and consecutive kept lanes write
// consecutive addresses.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 1024;         // lanes of a CUDA block, one a thread
constexpr int QUADS = CHUNK / 4;    // 4-lane quads of a chunk
constexpr int WARPS = CHUNK / 32;   // 32: one scan word a warp
constexpr int MAX_ROWS = 8;         // rows a thread moves at most
constexpr int EARLY_ROWS = 4;       // of them loaded before the scan
constexpr int COPY_THREADS = 256;
constexpr int COPY_UNROLL = 4;      // 16-byte words a copy thread moves

// Bit j set where lane lane0 + j of keep is kept (lanes at or past end are
// not).  vec: lane0 is a multiple of 4 and keep is aligned, so one 16-byte
// (float) or 4-byte (bool) load reads the quad.
__device__ __forceinline__ unsigned quad_mask(const void* __restrict__ keep,
                                              int is_float, int vec,
                                              long long lane0, long long end) {
  unsigned m = 0;
  if (vec && lane0 + 4 <= end) {
    if (is_float) {
      const float4 v = *reinterpret_cast<const float4*>(
          static_cast<const float*>(keep) + lane0);
      m = (v.x != 0.0f) | ((v.y != 0.0f) << 1) | ((v.z != 0.0f) << 2) |
          ((v.w != 0.0f) << 3);
    } else {
      const unsigned v = *reinterpret_cast<const unsigned*>(
          static_cast<const unsigned char*>(keep) + lane0);
      m = ((v & 0xffu) != 0) | (((v >> 8) & 0xffu) != 0) << 1 |
          (((v >> 16) & 0xffu) != 0) << 2 | ((v >> 24) != 0) << 3;
    }
    return m;
  }
  for (int j = 0; j < 4; ++j) {
    const long long k = lane0 + j;
    if (k < end) {
      const bool f = is_float ? static_cast<const float*>(keep)[k] != 0.0f
                              : static_cast<const unsigned char*>(keep)[k] != 0;
      m |= (unsigned)f << j;
    }
  }
  return m;
}

// Exclusive sum of v over the 1024 threads in thread order, the total in
// *total.  Every thread calls it; it holds two __syncthreads, and a second
// call must first pass a __syncthreads (they share wsum).
__device__ __forceinline__ int block_excl_sum(int v, int* total, int* wsum) {
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
  if (warp == 0) {
    const int c = wsum[lane];
    int w = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    wsum[lane] = w - c;
    if (lane == 31) wsum[WARPS] = w;
  }
  __syncthreads();
  *total = wsum[WARPS];
  return wsum[warp] + s - v;
}

template <int ROWS>  // rows a thread moves at most: 4 or MAX_ROWS
__global__ void __launch_bounds__(CHUNK, 2)
compact_kernel(const float* __restrict__ pk, const void* __restrict__ keep,
               int keep_is_float, int vec, float* __restrict__ out,
               int* __restrict__ counts, int rows, long long ncols, int block,
               int rows_per_group) {
  __shared__ int wsum[WARPS + 1];
  __shared__ int qoff[QUADS];             // kept lanes of the block before
  __shared__ unsigned char qmask[QUADS];  // the chunk's quads; their masks
  const int t = threadIdx.x;
  const int c = blockIdx.y;
  const long long base = (long long)blockIdx.x * block;
  const long long end = base + block;
  const int lane = CHUNK * c + t;         // this thread's lane and slot
  const int r0 = blockIdx.z * rows_per_group;
  const int nr = lane < block ? min(rows_per_group, rows - r0) : 0;
  float v[ROWS];
#pragma unroll
  for (int k = 0; k < EARLY_ROWS; ++k)
    if (k < nr) v[k] = pk[(r0 + k) * ncols + base + lane];
  const int nq = (block + 3) / 4;
  int count = 0;                          // kept lanes of the quads so far
  for (int q0 = 0; q0 < nq; q0 += CHUNK) {  // uniform over the block
    const int q = q0 + t;
    const unsigned m =
        q < nq ? quad_mask(keep, keep_is_float, vec, base + 4LL * q, end) : 0u;
    int total;
    const int pos = block_excl_sum(__popc(m), &total, wsum);
    const int qc = q - QUADS * c;
    if (qc >= 0 && qc < QUADS) {
      qoff[qc] = count + pos;
      qmask[qc] = (unsigned char)m;
    }
    count += total;
    __syncthreads();  // wsum is reused; qoff and qmask are read below
  }
#pragma unroll
  for (int k = EARLY_ROWS; k < ROWS; ++k)
    if (k < nr) v[k] = pk[(r0 + k) * ncols + base + lane];
  if (lane < block) {
    const unsigned m = qmask[t >> 2];
    const int j = t & 3;
    if ((m >> j) & 1u) {
      const long long dst =
          base + qoff[t >> 2] + __popc(m & ((1u << j) - 1u));
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (k < nr) out[(r0 + k) * ncols + dst] = v[k];
    }
    if (lane >= count) {
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (k < nr) out[(r0 + k) * ncols + base + lane] = 0.0f;
    }
  }
  if (c == 0 && blockIdx.z == 0 && t == 0) counts[blockIdx.x] = count;
}

__global__ void __launch_bounds__(COPY_THREADS)
block_copy_kernel(const float* __restrict__ pk, float* __restrict__ out,
                  long long n, int vec, int* __restrict__ counts, int nblocks,
                  int block) {
  const long long tile = (long long)blockIdx.x * COPY_THREADS * COPY_UNROLL;
  if (vec) {
    const float4* __restrict__ src = reinterpret_cast<const float4*>(pk);
    float4* __restrict__ dst = reinterpret_cast<float4*>(out);
    const long long n4 = n >> 2;
    float4 v[COPY_UNROLL];
#pragma unroll
    for (int k = 0; k < COPY_UNROLL; ++k) {
      const long long i = tile + k * COPY_THREADS + threadIdx.x;
      if (i < n4) v[k] = src[i];
    }
#pragma unroll
    for (int k = 0; k < COPY_UNROLL; ++k) {
      const long long i = tile + k * COPY_THREADS + threadIdx.x;
      if (i < n4) dst[i] = v[k];
    }
    if (blockIdx.x == 0 && threadIdx.x < (n & 3))
      out[4 * n4 + threadIdx.x] = pk[4 * n4 + threadIdx.x];
  } else {
    float v[COPY_UNROLL];
#pragma unroll
    for (int k = 0; k < COPY_UNROLL; ++k) {
      const long long i = tile + k * COPY_THREADS + threadIdx.x;
      if (i < n) v[k] = pk[i];
    }
#pragma unroll
    for (int k = 0; k < COPY_UNROLL; ++k) {
      const long long i = tile + k * COPY_THREADS + threadIdx.x;
      if (i < n) out[i] = v[k];
    }
  }
  const long long b = (long long)blockIdx.x * COPY_THREADS + threadIdx.x;
  if (b < nblocks) counts[b] = block;
}

}  // namespace

// pk and out are (rows, ncols) float32, ncols = nblocks * block; keep is
// (ncols,) bool (keep_is_float = 0) or float32 with a lane kept where it is
// not 0 (keep_is_float = 1); vec = 1 when block is a multiple of 4 and keep is
// 16-byte (float) or 4-byte (bool) aligned; counts is (nblocks,) int32; the
// grid is (nblocks, ceil(block / 1024), ceil(rows / rows_per_group)), with
// 1 <= rows_per_group <= 4.  Returns a cudaError_t code, 0 on success.
extern "C" int compact_block(const float* pk, const void* keep,
                             int keep_is_float, int vec, float* out,
                             int* counts, int rows, long long ncols,
                             int block, int nblocks, int rows_per_group,
                             void* stream) {
  if (nblocks <= 0) return 0;
  if (rows < 0 || block <= 0 || (long long)block * nblocks != ncols ||
      rows_per_group < 1 || rows_per_group > MAX_ROWS)
    return (int)cudaErrorInvalidValue;
  const int groups = rows > 0 ? (rows + rows_per_group - 1) / rows_per_group
                              : 1;
  const dim3 grid(nblocks, (block + CHUNK - 1) / CHUNK, groups);
  if (rows_per_group <= EARLY_ROWS)
    compact_kernel<EARLY_ROWS><<<grid, CHUNK, 0, (cudaStream_t)stream>>>(
        pk, keep, keep_is_float, vec, out, counts, rows, ncols, block,
        rows_per_group);
  else
    compact_kernel<MAX_ROWS><<<grid, CHUNK, 0, (cudaStream_t)stream>>>(
        pk, keep, keep_is_float, vec, out, counts, rows, ncols, block,
        rows_per_group);
  return (int)cudaGetLastError();
}

// out = pk, n float32 each; vec = 1 when both are 16-byte aligned; counts
// (nblocks,) int32 all set to block.  Returns a cudaError_t code.
extern "C" int block_copy(const float* pk, float* out, long long n, int vec,
                          int* counts, int nblocks, int block, void* stream) {
  if (n < 0 || nblocks < 0) return (int)cudaErrorInvalidValue;
  const long long per = (long long)COPY_THREADS * COPY_UNROLL;
  long long grid = ((vec ? n >> 2 : n) + per - 1) / per;
  const long long need = ((long long)nblocks + COPY_THREADS - 1) / COPY_THREADS;
  if (grid < need) grid = need;
  if (grid == 0) return 0;
  block_copy_kernel<<<(unsigned)grid, COPY_THREADS, 0,
                      (cudaStream_t)stream>>>(pk, out, n, vec, counts,
                                              nblocks, block);
  return (int)cudaGetLastError();
}

extern "C" const char* compact_block_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
