// fused_push2d.cu -- the particle push of the 2-D main path, written by hand
// for Hopper (sm_90a).
//
// Replaces: vpic_tpu/ops/pallas_push.py::_kernel (the Pallas TPU kernel that
// fuses interpolation, the Boris push and the charge-conserving streak walk
// with its current deposition).  It computes what vpic_tpu/ops/push.py
// advance_p computes for periodic and reflecting particle faces; its plain
// PyTorch twin is vpic_tpu_torch/ops/push.py::advance_p.
//
// One thread per particle lane runs push_lane() (push_lane.cuh, shared with
// the 3-D kernel): coefficient read, Boris push, streak walk with atomicAdd
// deposits into the (nv, 12) float32 accumulator, periodic wrap and
// reflecting bounce.  The particle arrays are updated IN PLACE; dead lanes
// pass through untouched.  Lanes still walking after max_streak rounds are
// counted into *unfinished.  The kernel allocates nothing.
//
// What bounds it on the H100: memory and atomic throughput, not FLOPs.  Per
// lane it reads ~40 bytes of particle state plus a 72-byte coefficient row and
// issues 12 atomics per walk round (12-48 per lane); the arithmetic is ~150
// flops.  The lanes are voxel-sorted (bucket_sort_p), so the coefficient rows
// of a warp mostly hit one or two cache lines, but the same sorting makes the
// 32 lanes of a warp add into the same 12 accumulator addresses, and those
// atomics serialise in L2.  This first version is simple on purpose: it is
// the correctness baseline.  Warp-aggregated or shared-memory tile deposits
// are later work.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 without
// --use_fast_math: the divisions and sqrtf stay IEEE.  The entry point
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "push_lane.cuh"

namespace {

using vpic_push::Lane;
using vpic_push::PushParams;

struct PushArgs {
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
};

__global__ void fused_push2d_kernel(PushArgs p) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= p.n || !p.live[k]) return;

  Lane L;
  L.px = p.dx[k];
  L.py = p.dy[k];
  L.pz = p.dz[k];
  L.ux = p.ux[k];
  L.uy = p.uy[k];
  L.uz = p.uz[k];
  if (vpic_push::push_lane(p.pp, p.vox[k], p.w[k], L))
    atomicAdd(p.unfinished, 1);

  const int NX = p.pp.nx + 2;
  const int NY = p.pp.ny + 2;
  p.dx[k] = L.px;
  p.dy[k] = L.py;
  p.dz[k] = L.pz;
  p.vox[k] = L.xi + NX * (L.yi + NY * L.zi);
  p.ux[k] = L.ux;
  p.uy[k] = L.uy;
  p.uz[k] = L.uz;
}

}  // namespace

extern "C" int fused_push2d(float* dx, float* dy, float* dz, int* vox,
                            float* ux, float* uy, float* uz, const float* w,
                            const bool* live, const float* fcoef, float* acc,
                            int* unfinished, int n, float qdt_2mc, float qsp,
                            float cdt_dx, float cdt_dy, float cdt_dz, int nx,
                            int ny, int nz, int periodic_x, int periodic_y,
                            int periodic_z, int max_streak, void* stream) {
  if (n <= 0) return 0;
  PushArgs a;
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
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  fused_push2d_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* fused_push2d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
