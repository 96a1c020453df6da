// fused_push2d.cu -- the particle push of the 2-D main path, written by hand
// for Hopper (sm_90a).
//
// Replaces: vpic_tpu/ops/pallas_push.py::_kernel (the Pallas TPU kernel that
// fuses interpolation, the Boris push and the charge-conserving streak walk
// with its current deposition, all species in one launch).  It computes what
// vpic_tpu/ops/push.py advance_p computes on one device, every particle face
// included; its plain PyTorch twin is vpic_tpu_torch/ops/push.py::advance_p.
//
// One launch pushes every species (up to MAX_SPECIES; the species table is a
// __grid_constant__ parameter).  Each CUDA block of LANES threads takes a
// fixed run of LANES lanes of one species, one thread per lane:
//   1. the block reduces its live lanes' voxel range [lo, hi] (warp
//      __reduce_min/max_sync, then shared atomics);
//   2. its deposit tile is the span of linear voxels [lo - (NX+1),
//      hi + NX + 1] (every voxel a round can reach from [lo, hi]: the
//      neighbours along x and y), cut at TILE_VOX voxels, zeroed in dynamic
//      shared memory;
//   3. every live lane runs push_lane() (push_lane.cuh, shared with the 3-D
//      kernel): coefficient read, Boris push, streak walk with its deposits
//      into the tile, or into the (nv, 12) accumulator where the round's
//      voxel lies outside it (a block of unsorted lanes, a periodic wrap),
//      periodic wrap and reflecting bounce; in the WALLS instance also the
//      absorbing, custom and per-voxel-face (vbc) rules (push_lane.cuh item
//      5): a lane that meets one stops on the face, dies or is parked, and
//      every lane's pend code and remaining displacement are written for
//      boundary_p (pallas_push.py's wall pre-flag, :439-474, and the outlier
//      replay it feeds, :972-1048, are what this replaces).  The particle
//      arrays are updated IN PLACE; dead lanes pass through untouched;
//   4. after a __syncthreads the block adds each non-zero tile entry into the
//      accumulator with one atomic; the tile is a contiguous run of
//      accumulator rows, so the flush is coalesced.
// Lanes still walking after max_streak rounds are counted into *unfinished,
// and the rounds that took the global path (and all rounds) into
// deposits[0] (deposits[1]).  The kernel allocates nothing.
//
// What bounds it on the H100: not FLOPs or bytes (per lane ~40 bytes of
// particle state and a 72-byte coefficient row, ~150 flops: 18.3 MB, a
// 0.0055 ms bound for both species at 64^2 x 64 ppc), but the deposits.  One
// device atomic per current per round, with a bucket-sorted launch putting
// ~8,192 lanes of a species on ~1,536 accumulator addresses, serialised in
// L2: 0.155-0.163 ms a push of both species in two launches.  With the
// tiles, 0.2 % of the rounds take the global path right after a sort and
// 3.2 % seven pushes later (2.1 % over a 200-step run), and the push takes
// 0.043-0.044 ms in one launch.  With the deposits left out it took
// 0.018-0.019 ms, so the shared-memory compare-and-swap loops (push_lane.cuh)
// are most of what is left.  A tile centred on the lanes' mean voxel where
// the range is too wide was 0.056 ms seven pushes after a sort, against
// 0.043 for this cut.  64 registers a thread hold one 1024-thread block per
// SM.  The WALLS instance takes 0.0147 ms at the lpi deck (65,536 live
// lanes in 131,072 slots; bytes bound 0.0025 ms), and harris runs the
// instance without the wall code at the parent's time.  (NVIDIA H100 80GB
// HBM3, 700 W: device time from utils/push_timing.py and chip_smoke.py,
// the global-path shares from chip_smoke.py; PERF.md.)
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 without
// --use_fast_math: the divisions and sqrtf stay IEEE.  The entry point
// returns cudaGetLastError() after the launch.

#include <climits>
#include <cuda_runtime.h>

#include "push_lane.cuh"

namespace {

using vpic_push::Lane;
using vpic_push::MAX_SPECIES;
using vpic_push::PushParams;
using vpic_push::Rounds;
using vpic_push::Species;
using vpic_push::SpanTile;
using vpic_push::TILE_STRIDE;

constexpr int LANES = 1024;      // lanes (and threads) per CUDA block
constexpr int TILE_VOX = 1024;   // the tile's capacity in voxels
constexpr int TILE_FLOATS = TILE_VOX * TILE_STRIDE;
constexpr int TILE_BYTES = TILE_FLOATS * (int)sizeof(float);  // 53,248 B

struct Push2dArgs {
  Species sp[MAX_SPECIES];
  int nsp;
  PushParams pp;
  int* unfinished;               // (1,)
  unsigned long long* deposits;  // (2,)
};

template <bool WALLS>
__global__ void __launch_bounds__(LANES)
    fused_push2d_kernel(const __grid_constant__ Push2dArgs p) {
  extern __shared__ float tile[];  // TILE_VOX x TILE_STRIDE
  __shared__ int range[2];
  __shared__ unsigned counts[3];
  const int t = threadIdx.x;
  const Species& S = p.sp[vpic_push::species_of_block(p.sp, p.nsp)];
  const int k = ((int)blockIdx.x - S.blk0) * LANES + t;
  const bool live = k < S.n && S.live[k];
  const int v = live ? S.vox[k] : 0;

  if (t == 0) {
    range[0] = INT_MAX;
    range[1] = -1;
    counts[0] = counts[1] = counts[2] = 0;
  }
  __syncthreads();
  const int wlo = __reduce_min_sync(vpic_push::FULL, live ? v : INT_MAX);
  const int whi = __reduce_max_sync(vpic_push::FULL, live ? v : -1);
  if ((t & 31) == 0) {
    atomicMin(&range[0], wlo);
    atomicMax(&range[1], whi);
  }
  __syncthreads();
  const int lo = range[0];
  const int hi = range[1];
  const int NX = p.pp.nx + 2;
  const int nv = NX * (p.pp.ny + 2) * (p.pp.nz + 2);
  SpanTile T;
  T.base = (unsigned)__cvta_generic_to_shared(tile);
  T.v0 = max(lo - NX - 1, 0);
  // cut at TILE_VOX when the range is wider (unsorted lanes, or lanes that
  // wrapped across a periodic face since the last sort)
  T.len = hi >= lo ? min(min(hi + NX + 1, nv - 1) - T.v0 + 1, TILE_VOX) : 0;
  for (int e = t; e < T.len * TILE_STRIDE; e += LANES) tile[e] = 0.0f;
  __syncthreads();

  Rounds r = {0, 0};
  int unf = 0;
  Lane L;
  if (live) {
    L.px = S.dx[k];
    L.py = S.dy[k];
    L.pz = S.dz[k];
    L.ux = S.ux[k];
    L.uy = S.uy[k];
    L.uz = S.uz[k];
    if (vpic_push::push_lane<WALLS>(p.pp, T, S.qdt_2mc, S.qsp, S.qr8v, v,
                                    S.w[k], L, r))
      unf = 1;
    S.dx[k] = L.px;
    S.dy[k] = L.py;
    S.dz[k] = L.pz;
    S.vox[k] = L.xi + NX * (L.yi + (p.pp.ny + 2) * L.zi);
    S.ux[k] = L.ux;
    S.uy[k] = L.uy;
    S.uz[k] = L.uz;
  }
  if (WALLS && live) vpic_push::store_walls(S, k, L);
  __syncthreads();
  float* acc = p.pp.acc + (size_t)T.v0 * 12;
  for (int e = t; e < T.len * TILE_STRIDE; e += LANES) {
    const float a = tile[e];
    if (a == 0.0f) continue;  // untouched, or a pad word
    const int sl = e / TILE_STRIDE;
    atomicAdd(acc + sl * 12 + (e - sl * TILE_STRIDE), a);
  }
  vpic_push::add_counts(counts, r, unf, p.deposits, p.unfinished);
}

}  // namespace

// ptrs: vpic_push::SPECIES_PTRS pointers per species (home and emit null;
// pend and pdisp null unless walls); n, blk0, qdt_2mc, qsp, qr8v: one per
// species (host arrays); grid: CUDA blocks.  walls != 0 launches the WALLS
// instance with the six domain faces' particle BC codes `bc` (host array),
// the (nv, 6) vbc table (or null) and the (nv,) rhob.
extern "C" int fused_push2d(int nsp, void* const* ptrs, const int* n,
                            const int* blk0, const float* qdt_2mc,
                            const float* qsp, const float* qr8v, int grid,
                            const float* fcoef, float* acc, int* unfinished,
                            unsigned long long* deposits, float cdt_dx,
                            float cdt_dy, float cdt_dz, int nx, int ny,
                            int nz, int periodic_x, int periodic_y,
                            int periodic_z, int max_streak, int walls,
                            const int* bc, const int* vbc, float* rhob,
                            void* stream) {
  if (grid <= 0) return 0;
  if (nsp < 1 || nsp > MAX_SPECIES) return (int)cudaErrorInvalidValue;
  if (walls && !rhob) return (int)cudaErrorInvalidValue;
  Push2dArgs a;
  vpic_push::fill_species(a.sp, nsp, ptrs, n, blk0, nullptr, qdt_2mc, qsp,
                          qr8v);
  a.nsp = nsp;
  a.pp.fcoef = fcoef;
  a.pp.acc = acc;
  a.pp.cdt_dx = cdt_dx;
  a.pp.cdt_dy = cdt_dy;
  a.pp.cdt_dz = cdt_dz;
  a.pp.nx = nx;
  a.pp.ny = ny;
  a.pp.nz = nz;
  a.pp.periodic_x = periodic_x;
  a.pp.periodic_y = periodic_y;
  a.pp.periodic_z = periodic_z;
  a.pp.max_streak = max_streak;
  for (int f = 0; f < 6; ++f) a.pp.bc[f] = walls ? bc[f] : 0;
  a.pp.vbc = vbc;
  a.pp.rhob = rhob;
  a.unfinished = unfinished;
  a.deposits = deposits;
  auto kernel = walls ? &fused_push2d_kernel<true> : &fused_push2d_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, LANES, TILE_BYTES, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// CUDA blocks of the kernel (the WALLS instance if walls) one SM holds at
// once (registers, shared memory).
extern "C" int fused_push2d_blocks_per_sm(int walls) {
  auto kernel = walls ? &fused_push2d_kernel<true> : &fused_push2d_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TILE_BYTES);
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, LANES,
                                                TILE_BYTES);
  return blocks;
}

extern "C" const char* fused_push2d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
