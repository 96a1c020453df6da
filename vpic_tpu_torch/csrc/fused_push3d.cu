// fused_push3d.cu -- the particle push of the 3-D path, with the residency
// epilogue, written by hand for Hopper (sm_90a).
//
// Replaces: vpic_tpu/ops/pallas_push3d.py::_kernel3d (the Pallas TPU kernel
// that pushes 1024-lane blocks of every species in one launch against 8x8x8
// brick charts and, in residency mode, copies each block's brick-leavers
// into a per-block outbox).  Its plain PyTorch twin is
// vpic_tpu_torch/ops/fused_push3d.py::fused_push3d_multi_ref.
//
// One launch pushes every species (up to MAX_SPECIES; the species table,
// with each species' qdt_2mc, qsp, first CUDA block and first outbox
// column, is a __grid_constant__ parameter).  Each CUDA block of 1024
// threads serves a run of `run` consecutive 1024-lane layout blocks of one
// species, one at a time, one thread per lane (the wrapper sizes the run so
// the grid is a few waves of the SMs).  A brick's layout blocks are
// contiguous in the quantized brick sort, so a run mostly shares one home:
//   0. when a layout block's home brick differs from the tile's, the block
//      flushes the tile (below) and zeroes a new one: the home brick and a
//      one-cell halo, 10^3 voxels x TILE_STRIDE floats = 52,000 B of dynamic
//      shared memory.  Without a home map the block has no tile, and the
//      grid need not be one the bricks tile (the deck's general path
//      pushes such 3-D grids this way, every deposit on the global path);
//   1. every live lane runs push_lane() (push_lane.cuh, shared with the 2-D
//      kernel) on canonical voxels: coefficient read from the (nv, 18) table,
//      Boris push, streak walk, periodic wrap and reflecting bounce, and in
//      the WALLS instance the absorbing, custom and per-voxel-face rules
//      (pallas_push3d.py's pre-flag, :550-576, and region mark, :578-590,
//      with the outlier replay they feed), writing every lane's pend code and
//      remaining displacement for boundary_p.  A lane
//      moves less than a cell a step, so a lane that starts in its home brick
//      deposits inside the tile; the rounds of other lanes (leavers past the
//      outbox cap that stay resident, lanes of a tight-packed block outside
//      its home) and of rounds that wrapped across a periodic face to the far
//      side of the domain take the global path: atomicAdd into the (nv, 12)
//      accumulator, counted.  The lane arrays are updated IN PLACE; dead
//      lanes pass through untouched;
//   2. residency mode, per layout block and in lane order: a live lane whose
//      final voxel is outside the home brick's 8^3 interior is a leaver
//      (pallas_push3d.py:796-802); a lane that died or was parked at a wall
//      is not (the TPU kernel froze such lanes in their home brick for the
//      replay, which runs before the exchange; here boundary_p does).  The first out_cap leavers (block_scan.cuh:
//      warp ballots and __popc, no atomic counter -- plan_exchange's stable
//      sort depends on the order) are copied into the block's outbox columns
//      (dx, dy, dz, ux, uy, uz, w as float rows, the voxel as int32, a valid
//      mark) and get their emit mark; the outbox columns past them are
//      zeroed.  Leavers past the cap stay resident and are counted into *ores
//      (pallas_push3d.py:803-827);
//   3. at the end of a run (or of a home), a __syncthreads, then one atomic
//      per non-zero tile entry into the accumulator.
// Lanes still walking after max_streak rounds are counted into *unfinished,
// global-path rounds (and all rounds) into deposits[0] (deposits[1]).  The
// kernel allocates nothing.
//
// What bounds it on the H100: not FLOPs, and not bytes (per live lane ~33 B
// read and ~29 B written, plus the coefficient rows, L2-resident at 34^3
// cells, and the outbox: at the 32^3 x 128 ppc deck ~0.29 GB, ~0.086 ms at
// 3.35 TB/s).  One device atomic per current per round (>= 50 M a push at
// that deck), with every block of a brick adding into the same 512 x 12
// addresses, serialised in L2: 1.63-1.67 ms a push of both species in two
// launches, about 5 % of the bytes bound.  With the brick tiles 0.55 % of
// the rounds take the global path, the device atomics are the flushes
// (~10^4 per run), and the push takes 0.52-0.55 ms in one launch.  What is
// left: the shared compare-and-swap loops (push_lane.cuh; with the deposits
// left out the push takes 0.30-0.31 ms), and the epilogue's scan with its
// __syncthreads per layout block, where the one 1024-thread block an SM
// holds (64 registers a thread) waits for its slowest lane's walk (without
// the epilogue the push takes 0.36-0.39 ms).  The run length moves nothing
// measurable (one, two or four waves of the SMs).  The WALLS instance takes
// 0.194 ms on a 32^3 x 32 ppc deck with an absorbing region (1,048,576
// lanes, residency; bytes bound 0.030 ms).  (NVIDIA H100 80GB HBM3, 700 W;
// utils/push_timing.py, chip_smoke.py; PERF.md.)
//
// __launch_bounds__(1024) caps the kernel at 64 registers a thread so a
// 1024-thread block always launches; ptxas reports any spill.  Built with
// nvcc -gencode arch=compute_90a,code=sm_90a -O3 without --use_fast_math.
// The entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "push_lane.cuh"

namespace {

using vpic_push::BoxTile;
using vpic_push::Lane;
using vpic_push::MAX_SPECIES;
using vpic_push::PushParams;
using vpic_push::Rounds;
using vpic_push::Species;
using vpic_push::TILE_STRIDE;
using vpic_scan::BLOCK;

constexpr int B3 = 8;              // brick side (cells)
constexpr int TE = B3 + 2;         // tile side: the brick and a one-cell halo
constexpr int TILE_FLOATS = TE * TE * TE * TILE_STRIDE;
constexpr int TILE_BYTES = TILE_FLOATS * (int)sizeof(float);  // 52,000 B

struct Push3dArgs {
  Species sp[MAX_SPECIES];
  int nsp;
  int run;  // layout blocks per CUDA block
  PushParams pp;
  int* unfinished;               // (1,)
  unsigned long long* deposits;  // (2,)
  // residency epilogue
  int residency;
  float* obx_f;      // (7, obx_stride): dx dy dz ux uy uz w
  int* obx_vox;      // (obx_stride,)
  bool* obx_valid;   // (obx_stride,)
  int obx_stride;
  int* ores;         // (1,)
  int out_cap;
};

// Adds each non-zero tile entry into the accumulator; every thread calls it
// after a __syncthreads.
__device__ __forceinline__ void flush_tile(const float* tile,
                                           const BoxTile& T,
                                           const PushParams& pp) {
  const size_t NX = pp.nx + 2;
  const size_t NY = pp.ny + 2;
  for (int e = threadIdx.x; e < TILE_FLOATS; e += BLOCK) {
    const float a = tile[e];
    if (a == 0.0f) continue;  // untouched, or a pad word
    const int lv = e / TILE_STRIDE;
    const int lx = lv % TE;
    const int ly = lv / TE % TE;
    const int lz = lv / (TE * TE);
    const size_t v = (size_t)(T.x0 + lx) +
                     NX * ((size_t)(T.y0 + ly) + NY * (size_t)(T.z0 + lz));
    atomicAdd(pp.acc + v * 12 + (e - lv * TILE_STRIDE), a);
  }
}

template <bool WALLS>
__global__ void __launch_bounds__(BLOCK)
    fused_push3d_kernel(const __grid_constant__ Push3dArgs p) {
  extern __shared__ float tile[];  // TILE_FLOATS
  __shared__ unsigned counts[3];
  const int t = threadIdx.x;
  const Species& S = p.sp[vpic_push::species_of_block(p.sp, p.nsp)];
  const int nblk = (S.n + BLOCK - 1) / BLOCK;
  const int b_begin = ((int)blockIdx.x - S.blk0) * p.run;
  const int b_end = min(b_begin + p.run, nblk);
  const int nbx = p.pp.nx / B3;
  const int nby = p.pp.ny / B3;
  const int NX = p.pp.nx + 2;
  const int NY = p.pp.ny + 2;
  if (t == 0) counts[0] = counts[1] = counts[2] = 0;

  BoxTile T;
  T.base = (unsigned)__cvta_generic_to_shared(tile);
  T.x0 = T.y0 = T.z0 = 0;
  T.e = 0;
  int cur = -1;  // the tile's home brick, -1: no tile
  Rounds r = {0, 0};
  int unf = 0;
  for (int b = b_begin; b < b_end; ++b) {
    const int home = S.home ? S.home[b] : -1;  // uniform over the block
    // the home brick's indices, read only in residency mode (which has a
    // home map); without one the grid may be one the bricks do not tile
    const int hx = home >= 0 ? home % nbx : -1;
    const int hy = home >= 0 ? (home / nbx) % nby : -1;
    const int hz = home >= 0 ? home / (nbx * nby) : -1;
    if (home != cur) {
      __syncthreads();
      if (cur >= 0) {
        flush_tile(tile, T, p.pp);
        __syncthreads();
      }
      if (home >= 0) {
        for (int e = t; e < TILE_FLOATS; e += BLOCK) tile[e] = 0.0f;
        T.x0 = hx * B3;
        T.y0 = hy * B3;
        T.z0 = hz * B3;
        T.e = TE;
      } else {
        T.e = 0;
      }
      cur = home;
      __syncthreads();
    }

    const int k = b * BLOCK + t;
    const bool live = k < S.n && S.live[k];
    Lane L;
    L.xi = L.yi = L.zi = 0;
    L.pend = vpic_push::DONE;
    L.dead = false;
    if (live) {
      L.px = S.dx[k];
      L.py = S.dy[k];
      L.pz = S.dz[k];
      L.ux = S.ux[k];
      L.uy = S.uy[k];
      L.uz = S.uz[k];
      if (vpic_push::push_lane<WALLS>(p.pp, T, S.qdt_2mc, S.qsp, S.qr8v,
                                      S.vox[k], S.w[k], L, r))
        ++unf;
      S.dx[k] = L.px;
      S.dy[k] = L.py;
      S.dz[k] = L.pz;
      S.vox[k] = L.xi + NX * (L.yi + NY * L.zi);
      S.ux[k] = L.ux;
      S.uy[k] = L.uy;
      S.uz[k] = L.uz;
    }
    if (WALLS && live) vpic_push::store_walls(S, k, L);
    if (!p.residency) continue;  // uniform over the launch

    const bool stopped = WALLS && (L.dead || L.pend >= vpic_push::CUSTOM_BASE);
    const bool leave = live && !stopped && ((L.xi - 1) / B3 != hx ||
                                (L.yi - 1) / B3 != hy ||
                                (L.zi - 1) / B3 != hz);
    int total;
    const int pos = vpic_scan::block_excl_count(leave, &total);
    const bool em = leave && pos < p.out_cap;
    if (k < S.n) S.emit[k] = em;

    const size_t col0 = (size_t)S.obx_col0 + (size_t)b * p.out_cap;
    const size_t SS = (size_t)p.obx_stride;
    if (em) {
      const size_t c = col0 + pos;
      p.obx_f[0 * SS + c] = L.px;
      p.obx_f[1 * SS + c] = L.py;
      p.obx_f[2 * SS + c] = L.pz;
      p.obx_f[3 * SS + c] = L.ux;
      p.obx_f[4 * SS + c] = L.uy;
      p.obx_f[5 * SS + c] = L.uz;
      p.obx_f[6 * SS + c] = S.w[k];
      p.obx_vox[c] = S.vox[k];
    }
    const int nem = total < p.out_cap ? total : p.out_cap;
    if (t < p.out_cap) {
      const size_t c = col0 + t;
      p.obx_valid[c] = t < nem;
      if (t >= nem) {
#pragma unroll
        for (int j = 0; j < 7; ++j) p.obx_f[j * SS + c] = 0.0f;
        p.obx_vox[c] = 0;
      }
    }
    if (t == 0 && total > p.out_cap) atomicAdd(p.ores, total - p.out_cap);
    __syncthreads();  // the next layout block's scan reuses its shared words
  }
  if (cur >= 0) {
    __syncthreads();
    flush_tile(tile, T, p.pp);
  }
  vpic_push::add_counts(counts, r, unf, p.deposits, p.unfinished);
}

}  // namespace

// ptrs: vpic_push::SPECIES_PTRS pointers per species (home null without a
// home map, emit null without residency, pend and pdisp null unless walls);
// n, blk0, col0, qdt_2mc, qsp, qr8v: one per species (host arrays); grid:
// CUDA blocks, each serving `run` layout blocks.  walls != 0 launches the
// WALLS instance with the six domain faces' particle BC codes `bc` (host
// array), the (nv, 6) vbc table (or null) and the (nv,) rhob.
extern "C" int fused_push3d(
    int nsp, void* const* ptrs, const int* n, const int* blk0,
    const int* col0, const float* qdt_2mc, const float* qsp,
    const float* qr8v, int grid, int run, const float* fcoef, float* acc,
    int* unfinished, unsigned long long* deposits, float cdt_dx,
    float cdt_dy, float cdt_dz, int nx, int ny, int nz, int periodic_x,
    int periodic_y, int periodic_z, int max_streak, int residency,
    float* obx_f, int* obx_vox, bool* obx_valid, int obx_stride, int* ores,
    int out_cap, int walls, const int* bc, const int* vbc, float* rhob,
    void* stream) {
  if (grid <= 0) return 0;
  if (nsp < 1 || nsp > MAX_SPECIES || run < 1) return (int)cudaErrorInvalidValue;
  if (out_cap < 0 || out_cap > BLOCK) return (int)cudaErrorInvalidValue;
  if (walls && !rhob) return (int)cudaErrorInvalidValue;
  Push3dArgs a;
  vpic_push::fill_species(a.sp, nsp, ptrs, n, blk0, col0, qdt_2mc, qsp,
                          qr8v);
  a.nsp = nsp;
  a.run = run;
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
  a.residency = residency;
  a.obx_f = obx_f;
  a.obx_vox = obx_vox;
  a.obx_valid = obx_valid;
  a.obx_stride = obx_stride;
  a.ores = ores;
  a.out_cap = out_cap;
  auto kernel = walls ? &fused_push3d_kernel<true> : &fused_push3d_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, BLOCK, TILE_BYTES, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// CUDA blocks of the kernel (the WALLS instance if walls) one SM holds at
// once (registers, shared memory).
extern "C" int fused_push3d_blocks_per_sm(int walls) {
  auto kernel = walls ? &fused_push3d_kernel<true> : &fused_push3d_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       TILE_BYTES);
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, BLOCK,
                                                TILE_BYTES);
  return blocks;
}

extern "C" const char* fused_push3d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
