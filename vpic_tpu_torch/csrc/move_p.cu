// move_p.cu -- the walk of lanes that a boundary handler re-emits, written by
// hand for Hopper (sm_90a).
//
// Replaces: the plain streak walk that vpic_tpu/boundary_ops.py::
// _continue_walk runs over every lane of a species after a custom handler
// (maxwellian_reflux) gave the lanes parked at its face a new momentum and
// remaining displacement (the reference re-injects them through move_p,
// boundary_p.cc:440-494), and the one vpic_tpu/boundary.py _migrate_round
// runs (:176-190) to walk on the lanes a rank received from a neighbour:
// one launch per migration round per species.  The JAX package has no TPU kernel for it: the
// walk is plain jnp there, about 170 launches a round in PyTorch, which made
// it most of a walled step's launches.  Its plain PyTorch twin is
// vpic_tpu_torch/ops/move_p.py::move_p_ref.
//
// One launch walks one species: one thread per slot, and a thread whose slot
// is not both live and marked `active` returns at once (the wrapper sizes
// the grid from the capacity, so nothing is read back to the host).  A
// walking lane runs walk_lane<true>() (push_lane.cuh, the walk the push
// kernels run after their Boris push) from its offsets, momentum and voxel
// with its remaining displacement, against the rank's domain faces and,
// for received lanes, the per-voxel-face table (a handler's continuation
// passes none, as in the JAX package): periodic wrap, reflecting bounce, an
// absorbing face kills it (its charge into rhob), a custom face parks it
// again with pend = CUSTOM_BASE + face, a face another rank owns with pend
// = face (the lane leaves in the next round).  Every
// deposit takes the global path (atomicAdd into the (nv, 12) accumulator):
// a few lanes a step walk here.  The lane arrays, pend codes and remaining
// displacement are updated in place; a lane that died gets live = false and
// w = 0.
//
// What bounds it: the launch.  At lpi's width (131,072 slots a species,
// ~1 lane walking) each thread reads two bytes and returns.  Built with
// nvcc -gencode arch=compute_90a,code=sm_90a -O3 without --use_fast_math.
// The entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "push_lane.cuh"

namespace {

using vpic_push::Lane;
using vpic_push::PushParams;
using vpic_push::Rounds;

constexpr int THREADS = 256;

// No deposit tile: every round takes the global path.
struct NoTile {
  unsigned base = 0;
  __device__ __forceinline__ int slot(int, int, int, int) const { return -1; }
};

struct MoveArgs {
  float* dx;
  float* dy;
  float* dz;
  int* vox;
  float* ux;
  float* uy;
  float* uz;
  float* w;
  bool* live;
  const bool* active;
  int* pend;
  float* disp;  // (3, n)
  int n;
  float qsp;
  float qr8v;
  PushParams pp;
};

__global__ void __launch_bounds__(THREADS)
    move_p_kernel(const __grid_constant__ MoveArgs a) {
  const int k = (int)blockIdx.x * THREADS + (int)threadIdx.x;
  if (k >= a.n || !a.active[k] || !a.live[k]) return;
  const int NX = a.pp.nx + 2;
  const int SZ = NX * (a.pp.ny + 2);
  const int v = a.vox[k];
  const int zi = v / SZ;
  const int rem = v - zi * SZ;
  const int yi = rem / NX;
  const int xi = rem - yi * NX;
  const float w = a.w[k];
  const size_t n = (size_t)a.n;

  Lane L;
  L.px = a.dx[k];
  L.py = a.dy[k];
  L.pz = a.dz[k];
  L.ux = a.ux[k];
  L.uy = a.uy[k];
  L.uz = a.uz[k];
  L.pend = a.pend[k];
  Rounds r = {0, 0};
  vpic_push::walk_lane<true>(a.pp, NoTile{}, a.qsp * w, a.qr8v, w,
                             a.disp[k], a.disp[n + k], a.disp[2 * n + k], xi,
                             yi, zi, L, r);
  a.dx[k] = L.px;
  a.dy[k] = L.py;
  a.dz[k] = L.pz;
  a.vox[k] = L.xi + NX * (L.yi + (a.pp.ny + 2) * L.zi);
  a.ux[k] = L.ux;
  a.uy[k] = L.uy;
  a.uz[k] = L.uz;
  a.pend[k] = L.pend;
  a.disp[k] = L.dpx;
  a.disp[n + k] = L.dpy;
  a.disp[2 * n + k] = L.dpz;
  if (L.dead) {
    a.live[k] = false;
    a.w[k] = 0.0f;
  }
}

}  // namespace

// One species' n slots: lane arrays dx dy dz vox ux uy uz w live (updated in
// place), the (n,) active marks, the (n,) pend codes and (3, n) remaining
// displacement (in and out), qsp and qsp * r8V, the (nv, 12) accumulator and
// the (nv,) rhob (added to), the grid's interior cells, the rank's six
// domain faces' particle BC codes `bc` (host array) and the (nv, 6)
// per-voxel-face code table `vbc` or null.
extern "C" int move_p(int n, float* dx, float* dy, float* dz, int* vox,
                      float* ux, float* uy, float* uz, float* w, bool* live,
                      const bool* active, int* pend, float* disp, float qsp,
                      float qr8v, float* acc, float* rhob, int nx, int ny,
                      int nz, const int* bc, const int* vbc, int max_streak,
                      void* stream) {
  if (n <= 0) return 0;
  if (!acc || !rhob || !bc) return (int)cudaErrorInvalidValue;
  MoveArgs a;
  a.dx = dx;
  a.dy = dy;
  a.dz = dz;
  a.vox = vox;
  a.ux = ux;
  a.uy = uy;
  a.uz = uz;
  a.w = w;
  a.live = live;
  a.active = active;
  a.pend = pend;
  a.disp = disp;
  a.n = n;
  a.qsp = qsp;
  a.qr8v = qr8v;
  a.pp.fcoef = nullptr;
  a.pp.acc = acc;
  a.pp.cdt_dx = a.pp.cdt_dy = a.pp.cdt_dz = 0.0f;
  a.pp.nx = nx;
  a.pp.ny = ny;
  a.pp.nz = nz;
  a.pp.periodic_x = a.pp.periodic_y = a.pp.periodic_z = 0;
  a.pp.max_streak = max_streak;
  for (int f = 0; f < 6; ++f) a.pp.bc[f] = bc[f];
  a.pp.vbc = vbc;
  a.pp.rhob = rhob;
  const int grid = (n + THREADS - 1) / THREADS;
  move_p_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* move_p_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
