// fused_push3d.cu -- the particle push of the 3-D path, with the residency
// epilogue, written by hand for Hopper (sm_90a).
//
// Replaces: vpic_tpu/ops/pallas_push3d.py::_kernel3d (the Pallas TPU kernel
// that pushes 1024-lane blocks against 8x8x8 brick charts and, in residency
// mode, copies each block's brick-leavers into a per-block outbox).  Its
// plain PyTorch twin is vpic_tpu_torch/ops/fused_push3d.py::
// fused_push3d_multi_ref.
//
// One CUDA block of 1024 threads serves one 1024-lane block of the layout,
// one thread per lane:
//   1. every live lane runs push_lane() (push_lane.cuh, shared with the 2-D
//      kernel) on canonical voxels: coefficient read from the (nv, 18) table,
//      Boris push, streak walk with atomicAdd deposits into the (nv, 12)
//      accumulator, periodic wrap and reflecting bounce.  The lane arrays are
//      updated IN PLACE; dead lanes pass through untouched.  No brick chart,
//      halo or chart-exit flag exists here: the walk reaches any cell.  So no
//      lane is ever pre-flagged on a periodic/reflecting deck; the outlier
//      replay of other faces arrives with the boundary layer.
//   2. residency mode: the block reads its home brick from the concatenated
//      home map.  A live lane whose final voxel is outside the home brick's
//      8^3 interior is a leaver (pallas_push3d.py:796-802).  The first
//      out_cap leavers, IN LANE ORDER (block_scan.cuh: warp ballots and
//      __popc, no atomic counter -- plan_exchange's stable sort depends on
//      the order), are copied into the block's outbox columns (dx, dy, dz,
//      ux, uy, uz, w as float rows, the voxel as int32, a valid mark) and get
//      their emit mark; the outbox columns past them are zeroed.  Leavers
//      past the cap stay resident and are counted into *ores
//      (pallas_push3d.py:803-827).
// Lanes still walking after max_streak rounds are counted into *unfinished.
// The kernel allocates nothing.
//
// What bounds it on the H100: memory and atomics, not FLOPs.  Per live lane
// ~33 B read (8 lane words + live) and ~29 B written (7 lane words + emit),
// plus the coefficient rows (nv x 72 B, L2-resident at 34^3 cells) and the
// outbox (~4 % of lanes x 33 B): at the 32^3 x 128 ppc deck ~4.2 M lanes,
// ~0.26 GB, ~0.08 ms at 3.35 TB/s.  The 12 atomics per walk round are the
// expected limit, as in the 2-D kernel: brick-sorted lanes make a warp's
// atomics land on the few cells of one brick.  This version is simple on
// purpose (the correctness baseline): shared-memory brick-tile deposits
// (a brick's 10^3-cell accumulator tile fits in 48 KB) are the next step.
//
// __launch_bounds__(1024) caps the kernel at 64 registers a thread so a
// 1024-thread block always launches; ptxas reports any spill.  Built with
// nvcc -gencode arch=compute_90a,code=sm_90a -O3 without --use_fast_math.
// The entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "push_lane.cuh"

namespace {

using vpic_push::Lane;
using vpic_push::PushParams;
using vpic_scan::BLOCK;

constexpr int B3 = 8;  // brick side (cells)

struct Push3dArgs {
  float* dx;
  float* dy;
  float* dz;
  int* vox;
  float* ux;
  float* uy;
  float* uz;
  const float* w;
  const bool* live;
  int* unfinished;  // (1,)
  int n;
  PushParams pp;
  // residency epilogue
  int residency;
  const int* home;   // (nblocks,) block -> home brick
  bool* emit;        // (n,)
  float* obx_f;      // (7, obx_stride): dx dy dz ux uy uz w
  int* obx_vox;      // (obx_stride,)
  bool* obx_valid;   // (obx_stride,)
  int obx_stride;
  int obx_col0;      // this species' first outbox column
  int* ores;         // (1,)
  int out_cap;
};

__global__ void __launch_bounds__(BLOCK) fused_push3d_kernel(Push3dArgs p) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int k = b * BLOCK + t;
  const bool live = k < p.n && p.live[k];

  Lane L;
  L.xi = L.yi = L.zi = 0;
  if (live) {
    L.px = p.dx[k];
    L.py = p.dy[k];
    L.pz = p.dz[k];
    L.ux = p.ux[k];
    L.uy = p.uy[k];
    L.uz = p.uz[k];
    if (vpic_push::push_lane(p.pp, p.vox[k], p.w[k], L))
      atomicAdd(p.unfinished, 1);
    p.dx[k] = L.px;
    p.dy[k] = L.py;
    p.dz[k] = L.pz;
    p.vox[k] = L.xi + (p.pp.nx + 2) * (L.yi + (p.pp.ny + 2) * L.zi);
    p.ux[k] = L.ux;
    p.uy[k] = L.uy;
    p.uz[k] = L.uz;
  }
  if (!p.residency) return;  // uniform over the block

  const int nbx = p.pp.nx / B3;
  const int nby = p.pp.ny / B3;
  const int home = p.home[b];
  const int hx = home % nbx;
  const int hy = (home / nbx) % nby;
  const int hz = home / (nbx * nby);
  const bool leave = live && ((L.xi - 1) / B3 != hx || (L.yi - 1) / B3 != hy ||
                              (L.zi - 1) / B3 != hz);
  int total;
  const int pos = vpic_scan::block_excl_count(leave, &total);
  const bool em = leave && pos < p.out_cap;
  if (k < p.n) p.emit[k] = em;

  const size_t col0 = (size_t)p.obx_col0 + (size_t)b * p.out_cap;
  const size_t S = (size_t)p.obx_stride;
  if (em) {
    const size_t c = col0 + pos;
    p.obx_f[0 * S + c] = L.px;
    p.obx_f[1 * S + c] = L.py;
    p.obx_f[2 * S + c] = L.pz;
    p.obx_f[3 * S + c] = L.ux;
    p.obx_f[4 * S + c] = L.uy;
    p.obx_f[5 * S + c] = L.uz;
    p.obx_f[6 * S + c] = p.w[k];
    p.obx_vox[c] = p.vox[k];
  }
  const int nem = total < p.out_cap ? total : p.out_cap;
  if (t < p.out_cap) {
    const size_t c = col0 + t;
    p.obx_valid[c] = t < nem;
    if (t >= nem) {
#pragma unroll
      for (int r = 0; r < 7; ++r) p.obx_f[r * S + c] = 0.0f;
      p.obx_vox[c] = 0;
    }
  }
  if (t == 0 && total > p.out_cap) atomicAdd(p.ores, total - p.out_cap);
}

}  // namespace

extern "C" int fused_push3d(
    float* dx, float* dy, float* dz, int* vox, float* ux, float* uy,
    float* uz, const float* w, const bool* live, const float* fcoef,
    float* acc, int* unfinished, int n, float qdt_2mc, float qsp,
    float cdt_dx, float cdt_dy, float cdt_dz, int nx, int ny, int nz,
    int periodic_x, int periodic_y, int periodic_z, int max_streak,
    int residency, const int* home, bool* emit, float* obx_f, int* obx_vox,
    bool* obx_valid, int obx_stride, int obx_col0, int* ores, int out_cap,
    void* stream) {
  if (n <= 0) return 0;
  if (out_cap < 0 || out_cap > BLOCK) return (int)cudaErrorInvalidValue;
  Push3dArgs a;
  a.dx = dx;
  a.dy = dy;
  a.dz = dz;
  a.vox = vox;
  a.ux = ux;
  a.uy = uy;
  a.uz = uz;
  a.w = w;
  a.live = live;
  a.unfinished = unfinished;
  a.n = n;
  a.pp.fcoef = fcoef;
  a.pp.acc = acc;
  a.pp.qdt_2mc = qdt_2mc;
  a.pp.qsp = qsp;
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
  a.residency = residency;
  a.home = home;
  a.emit = emit;
  a.obx_f = obx_f;
  a.obx_vox = obx_vox;
  a.obx_valid = obx_valid;
  a.obx_stride = obx_stride;
  a.obx_col0 = obx_col0;
  a.ores = ores;
  a.out_cap = out_cap;
  const int blocks = (n + BLOCK - 1) / BLOCK;
  fused_push3d_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_push3d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
