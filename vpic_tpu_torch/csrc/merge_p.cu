// merge_p.cu -- the residency merge, written by hand for Hopper (sm_90a).
//
// Replaces: vpic_tpu/ops/residency.py::_merge_kernel (the Pallas TPU kernel
// that compacts each 1024-lane block's survivors with exact one-hot dots and
// appends the block's routed newcomers).  Its plain PyTorch twin is
// vpic_tpu_torch/ops/residency.py::merge_p_ref.
//
// One CUDA block of 1024 threads per 1024-lane block, one thread per lane,
// writing NEW arrays (the input lanes are only read):
//   * keepers (live and not emitted) move to the front in lane order: an
//     exclusive prefix count (block_scan.cuh) gives each its slot;
//   * the block's a_j newcomers follow, read from the destination-sorted
//     compact rows [starts_j, starts_j + a_j) that plan_exchange built;
//   * every other slot of the block is written as zeros (dead, voxel 0);
//   * a block with no keepers and no newcomers writes its input rows
//     verbatim with live 0, and w set to 0 where the input lane was dead
//     (residency.py:296-298).
// The result is bit-identical to residency.merge_p in every lane, dead lanes
// included.  Rows that merge_p moves through its one-hot dots lose the sign
// of a zero (x * 1 summed with +0 terms); the kernel adds +0.0f to each
// moved float to do the same.  Compact rows past the compact array read as
// zeros, as merge_p's zero-padded window does.
//
// What bounds it on the H100: bytes.  Per slot it reads 9 input words and
// the live/emit marks and writes 9 output words (~9 x 4 B x 2 per lane), over
// ~4.8 M slots at the 32^3 x 128 ppc deck: ~0.35 GB, ~0.1 ms at 3.35 TB/s.
// The design moves each row once, with coalesced reads and writes within a
// block (keepers stay in order, so a warp's stores go to one or two
// segments) and no atomics.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

using vpic_scan::BLOCK;

struct MergeArgs {
  const float* dx;
  const float* dy;
  const float* dz;
  const int* vox;
  const float* ux;
  const float* uy;
  const float* uz;
  const float* w;
  const bool* live;
  const bool* emit;
  float* odx;
  float* ody;
  float* odz;
  int* ovox;
  float* oux;
  float* ouy;
  float* ouz;
  float* ow;
  bool* olive;
  const float* cf;  // (7, cstride): dx dy dz ux uy uz w
  const int* cvox;  // (cstride,)
  int cstride;
  int m;            // valid compact columns
  const int* starts;  // (nblocks,) of this species
  const int* a;       // (nblocks,)
};

__global__ void __launch_bounds__(BLOCK) merge_kernel(MergeArgs p) {
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const size_t k = (size_t)b * BLOCK + t;
  const bool lv = p.live[k];
  const bool keep = lv && !p.emit[k];
  int nk;
  const int pos = vpic_scan::block_excl_count(keep, &nk);
  const int na = p.a[b];
  const int ntot = nk + na;

  if (ntot == 0) {  // uniform over the block
    p.odx[k] = p.dx[k];
    p.ody[k] = p.dy[k];
    p.odz[k] = p.dz[k];
    p.ovox[k] = p.vox[k];
    p.oux[k] = p.ux[k];
    p.ouy[k] = p.uy[k];
    p.ouz[k] = p.uz[k];
    p.ow[k] = lv ? p.w[k] : 0.0f;
    p.olive[k] = false;
    return;
  }

  const size_t base = (size_t)b * BLOCK;
  if (keep) {
    const size_t o = base + pos;
    p.odx[o] = p.dx[k] + 0.0f;
    p.ody[o] = p.dy[k] + 0.0f;
    p.odz[o] = p.dz[k] + 0.0f;
    p.ovox[o] = p.vox[k];
    p.oux[o] = p.ux[k] + 0.0f;
    p.ouy[o] = p.uy[k] + 0.0f;
    p.ouz[o] = p.uz[k] + 0.0f;
    p.ow[o] = p.w[k] + 0.0f;
    p.olive[o] = true;
  }
  if (t < na && nk + t < BLOCK) {
    const size_t o = base + nk + t;
    const long long c = (long long)p.starts[b] + t;
    const bool in = c >= 0 && c < p.m;
    const size_t S = (size_t)p.cstride;
    p.odx[o] = in ? p.cf[0 * S + c] + 0.0f : 0.0f;
    p.ody[o] = in ? p.cf[1 * S + c] + 0.0f : 0.0f;
    p.odz[o] = in ? p.cf[2 * S + c] + 0.0f : 0.0f;
    p.oux[o] = in ? p.cf[3 * S + c] + 0.0f : 0.0f;
    p.ouy[o] = in ? p.cf[4 * S + c] + 0.0f : 0.0f;
    p.ouz[o] = in ? p.cf[5 * S + c] + 0.0f : 0.0f;
    p.ow[o] = in ? p.cf[6 * S + c] + 0.0f : 0.0f;
    p.ovox[o] = in ? p.cvox[c] : 0;
    p.olive[o] = true;
  }
  if (t >= ntot) {
    p.odx[k] = 0.0f;
    p.ody[k] = 0.0f;
    p.odz[k] = 0.0f;
    p.ovox[k] = 0;
    p.oux[k] = 0.0f;
    p.ouy[k] = 0.0f;
    p.ouz[k] = 0.0f;
    p.ow[k] = 0.0f;
    p.olive[k] = false;
  }
}

}  // namespace

extern "C" int merge_p(const float* dx, const float* dy, const float* dz,
                       const int* vox, const float* ux, const float* uy,
                       const float* uz, const float* w, const bool* live,
                       const bool* emit, float* odx, float* ody, float* odz,
                       int* ovox, float* oux, float* ouy, float* ouz,
                       float* ow, bool* olive, const float* cf,
                       const int* cvox, int cstride, int m, const int* starts,
                       const int* a, int n, void* stream) {
  if (n <= 0) return 0;
  if (n % BLOCK) return (int)cudaErrorInvalidValue;
  MergeArgs g;
  g.dx = dx;
  g.dy = dy;
  g.dz = dz;
  g.vox = vox;
  g.ux = ux;
  g.uy = uy;
  g.uz = uz;
  g.w = w;
  g.live = live;
  g.emit = emit;
  g.odx = odx;
  g.ody = ody;
  g.odz = odz;
  g.ovox = ovox;
  g.oux = oux;
  g.ouy = ouy;
  g.ouz = ouz;
  g.ow = ow;
  g.olive = olive;
  g.cf = cf;
  g.cvox = cvox;
  g.cstride = cstride;
  g.m = m;
  g.starts = starts;
  g.a = a;
  merge_kernel<<<n / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

extern "C" const char* merge_p_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
