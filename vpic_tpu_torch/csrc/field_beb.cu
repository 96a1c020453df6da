// field_beb.cu -- the field trio advance_b(1/2), advance_e, advance_b(1/2) as
// one cooperative kernel, written by hand for Hopper (sm_90a).
//
// Replaces: scripts/field_fuse_proto.py::make_beb_kernel (the Pallas TPU
// kernel that holds the 12 ghosted field arrays in VMEM and runs the three
// stencils of vpic_tpu/ops/fields.py in one call).  Its plain PyTorch twin
// is vpic_tpu_torch/ops/field_fuse.py::beb_ref (ops/fields.advance_b,
// advance_e, advance_b: 122 small kernels per trio on an H100, counted by
// torch.profiler in vpic_tpu_torch/scripts/field_fuse_proto.py).
//
// One launch with cudaLaunchCooperativeKernel; every phase is a grid-stride
// loop over the (nz+2)(ny+2)(nx+2) voxels, and the phases are separated by
// cooperative_groups::this_grid().sync(), so no thread reads in one phase
// what another writes in it:
//   1. advance_b(1/2): cB -= 0.5 c dt curl E over each component's extent,
//      the interior plus the high boundary plane n+1 along its own axis
//      (ops/fields.py advance_b);
//   2. the tangential cB ghost planes (ops/fields.py ghost_tang_b): along each
//      transverse axis a ghost plane takes its source plane -- the far
//      interior plane on a periodic face, the mirror plane on a pec face,
//      the negated mirror plane on a symmetric or pmc face.  The plain
//      version fills x, then y, then z planes, so a point that is a ghost
//      along two axes takes its value through both; here each ghost point
//      maps every ghost coordinate to its source at once, which reads the
//      same value (each fill reads only planes that are not ghosts along its
//      own axis), and reads only points this phase does not write;
//   3. advance_e: TCA = curl(cB/mu) - damp TCA and E = decay E + drive (TCA
//      - cj jf) over each edge extent, with (1 + damp) c dt in the curl;
//      then tangential E and TCA are 0 on the whole boundary plane of each
//      pec face (ops/fields.py adjust_tang_e);
//   4. advance_b(1/2), as 1.
// Every product, sum and difference is rounded on its own, in the plain
// version's order (__fmul_rn, __fadd_rn, __fsub_rn: no FMA contraction),
// so the kernel computes the plain version's floats.
//
// What bounds it on the H100: bytes, 12 arrays read and 9 written, 21 x 4 B
// per voxel: 1.10 MB at the 64^2 harris grid and 3.30 MB at 32^3, 0.33 and
// 0.99 us at 3.35 TB/s.  Those grids are a few thousand warps, so one launch
// and three grid-wide barriers (a few microseconds) set the time; the
// design removes the plain version's launches, one per slice operation.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

struct BebArgs {
  float* e[3];      // ex ey ez, updated in place
  float* b[3];      // cbx cby cbz, updated in place
  float* tca[3];    // tcax tcay tcaz, updated in place
  const float* jf[3];
  int n[3];         // nx ny nz
  float pb[3];      // advance_b(1/2): 0.5 c dt / d, 0 on a flat axis
  float pe[3];      // advance_e: (1 + damp) c dt / d, 0 on a flat axis
  float damp;
  float cj;         // dt / eps0
  float decay[3];
  float drive[3];
  float rmu[3];
  int ghost[6];     // per face -x -y -z +x +y +z: 0 wrap, 1 mirror, -1 -mirror
  int pec[6];       // per face: 1 where tangential E and TCA are zeroed
};

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}

// cB -= p curl E at voxel v for every component whose extent holds q
// (INTH along the component's axis, INT along the other two).
__device__ __forceinline__ void advance_b_at(const BebArgs& p, const int q[3],
                                             long long v,
                                             const long long st[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    bool in = true;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      in = in && q[a] >= 1 && q[a] <= p.n[a] + (a == c ? 1 : 0);
    if (!in) continue;
    const int a1 = (c + 1) % 3;
    const int a2 = (c + 2) % 3;
    const float* e1 = p.e[a1];
    const float* e2 = p.e[a2];
    const float d = fsub(fmul(p.pb[a1], fsub(e2[v + st[a1]], e2[v])),
                         fmul(p.pb[a2], fsub(e1[v + st[a2]], e1[v])));
    p.b[c][v] = fsub(p.b[c][v], d);
  }
}

// The tangential cB ghost points at voxel v, each from its source point.
__device__ __forceinline__ void ghost_b_at(const BebArgs& p, const int q[3],
                                           long long v,
                                           const long long st[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    long long src = v;
    bool ghost = false;
    bool negate = false;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (a == c) continue;  // ghost_tang_b fills transverse axes only
      const int n = p.n[a];
      int mode, to;
      if (q[a] == 0) {
        mode = p.ghost[a];
        to = mode == 0 ? n : 1;
      } else if (q[a] == n + 1) {
        mode = p.ghost[a + 3];
        to = mode == 0 ? 1 : n;
      } else {
        continue;
      }
      ghost = true;
      negate = negate != (mode < 0);
      src += (long long)(to - q[a]) * st[a];
    }
    if (ghost) {
      const float s = p.b[c][src];
      p.b[c][v] = negate ? -s : s;
    }
  }
}

// E and TCA at voxel v: zero on a pec boundary plane of a transverse axis,
// else the update over the edge extent (INT along the component's axis,
// INTH along the other two).
__device__ __forceinline__ void advance_e_at(const BebArgs& p, const int q[3],
                                             long long v,
                                             const long long st[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int a1 = (c + 1) % 3;
    const int a2 = (c + 2) % 3;
    bool zero = false;
    bool in = q[c] >= 1 && q[c] <= p.n[c];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int a = k ? a2 : a1;
      zero = zero || (q[a] == 1 && p.pec[a]) ||
             (q[a] == p.n[a] + 1 && p.pec[a + 3]);
      in = in && q[a] >= 1 && q[a] <= p.n[a] + 1;
    }
    if (zero) {
      p.e[c][v] = 0.0f;
      p.tca[c][v] = 0.0f;
      continue;
    }
    if (!in) continue;
    const float* b1 = p.b[a1];
    const float* b2 = p.b[a2];
    const float curl =
        fsub(fmul(p.pe[a1], fsub(fmul(b2[v], p.rmu[a2]),
                                 fmul(b2[v - st[a1]], p.rmu[a2]))),
             fmul(p.pe[a2], fsub(fmul(b1[v], p.rmu[a1]),
                                 fmul(b1[v - st[a2]], p.rmu[a1]))));
    const float tca = fsub(curl, fmul(p.damp, p.tca[c][v]));
    const float e = fadd(fmul(p.decay[c], p.e[c][v]),
                         fmul(p.drive[c], fsub(tca, fmul(p.cj, p.jf[c][v]))));
    p.tca[c][v] = tca;
    p.e[c][v] = e;
  }
}

__global__ void field_beb_kernel(BebArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int NX = p.n[0] + 2;
  const int NY = p.n[1] + 2;
  const long long st[3] = {1, NX, (long long)NX * NY};
  const long long nvox = st[2] * (p.n[2] + 2);
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
#define VOXELS(body)                                          \
  for (long long v = first; v < nvox; v += stride) {          \
    const int q[3] = {(int)(v % NX), (int)((v / NX) % NY),    \
                      (int)(v / st[2])};                      \
    body(p, q, v, st);                                        \
  }
  VOXELS(advance_b_at)
  grid.sync();
  VOXELS(ghost_b_at)
  grid.sync();
  VOXELS(advance_e_at)
  grid.sync();
  VOXELS(advance_b_at)
#undef VOXELS
}

}  // namespace

// The 12 arrays are (nz+2, ny+2, nx+2) float32; coef holds pb[3], pe[3],
// damp, cj, decay[3], drive[3], rmu[3] (17 floats) and faces ghost[6],
// pec[6] (12 ints), as BebArgs.  The grid is as many blocks of `threads` as
// fit on the card at once (cooperative launch), at most one per `threads`
// voxels.  Returns a cudaError_t code, 0 on success.
extern "C" int field_beb(float* ex, float* ey, float* ez, float* cbx,
                         float* cby, float* cbz, float* tcax, float* tcay,
                         float* tcaz, const float* jfx, const float* jfy,
                         const float* jfz, int nx, int ny, int nz,
                         const float* coef, const int* faces, int threads,
                         void* stream) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaErrorInvalidValue;
  BebArgs a;
  float* e[3] = {ex, ey, ez};
  float* b[3] = {cbx, cby, cbz};
  float* t[3] = {tcax, tcay, tcaz};
  const float* j[3] = {jfx, jfy, jfz};
  const int n[3] = {nx, ny, nz};
  for (int k = 0; k < 3; ++k) {
    a.e[k] = e[k];
    a.b[k] = b[k];
    a.tca[k] = t[k];
    a.jf[k] = j[k];
    a.n[k] = n[k];
    a.pb[k] = coef[k];
    a.pe[k] = coef[3 + k];
    a.decay[k] = coef[8 + k];
    a.drive[k] = coef[11 + k];
    a.rmu[k] = coef[14 + k];
  }
  a.damp = coef[6];
  a.cj = coef[7];
  for (int k = 0; k < 6; ++k) {
    a.ghost[k] = faces[k];
    a.pec[k] = faces[6 + k];
  }

  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, field_beb_kernel, threads, 0);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next launch
    return (int)err;
  }
  const long long nvox = (long long)(nx + 2) * (ny + 2) * (nz + 2);
  long long blocks = (nvox + threads - 1) / threads;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)field_beb_kernel,
                                    dim3((unsigned)blocks), dim3(threads),
                                    args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* field_beb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
