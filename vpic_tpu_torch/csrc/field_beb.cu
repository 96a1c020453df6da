// field_beb.cu -- the field trio advance_b(1/2), advance_e, advance_b(1/2),
// written by hand for Hopper (sm_90a) as one cooperative kernel.
//
// Replaces: scripts/field_fuse_proto.py::make_beb_kernel (the Pallas TPU
// kernel that holds the 12 ghosted field arrays in VMEM and runs the three
// stencils of vpic_tpu/ops/fields.py in one call).  Its plain PyTorch twin
// is vpic_tpu_torch/ops/field_fuse.py::beb_ref (ops/fields.advance_b,
// advance_e, advance_b: 122 small kernels per trio on an H100, counted by
// torch.profiler in vpic_tpu_torch/scripts/field_fuse_proto.py).
//
// The trio is four phases; each reads what its neighbours wrote in the
// phase before, so a barrier separates them:
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
// What bounds it on the H100: not bytes (12 arrays read and 9 written, 21 x
// 4 B a voxel: 1.10 MB at the 64^2 harris grid, 0.33 us at 3.35 TB/s) but
// the chain of dependent steps -- a launch, four phases, the barriers
// between them -- on grids of a few thousand warps.
//
// field_beb_grid_kernel, the step's kernel at every grid size: one
// cooperative launch; every phase is a grid-stride loop over the voxels
// with 32-bit per-axis coordinates, and the phases are separated by
// grid-wide barriers.  It is kept in one launch rather than split into
// three ordinary launches at its barriers because the step is bound by the
// host's launches (one launch a trio).  A redesign that held the 12 arrays
// in the shared memory of 16 CTAs joined by DSMEM was slower at 64^2 and
// 32^3 (PERF.md) and is gone.

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

// cB_c's extent (INTH along c, INT across) and E_c's (INT along c, INTH
// across) hold q.
__device__ __forceinline__ bool in_b(const BebArgs& p, const int q[3],
                                     int c) {
  bool in = true;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    in = in && q[a] >= 1 && q[a] <= p.n[a] + (a == c ? 1 : 0);
  return in;
}
__device__ __forceinline__ bool in_e(const BebArgs& p, const int q[3],
                                     int c) {
  bool in = true;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    in = in && q[a] >= 1 && q[a] <= p.n[a] + (a == c ? 0 : 1);
  return in;
}

// Tangential E and TCA of component c are 0 at q: q lies on the boundary
// plane of a pec face of a transverse axis.
__device__ __forceinline__ bool pec_zero(const BebArgs& p, const int q[3],
                                         int c) {
  bool zero = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a == c) continue;
    zero = zero || (q[a] == 1 && p.pec[a]) ||
           (q[a] == p.n[a] + 1 && p.pec[a + 3]);
  }
  return zero;
}

// The source coordinate of a tangential cB_c ghost point along transverse
// axis a: q[a] itself where q is no ghost along a.  Sets ghost and flips
// negate where it is one.
__device__ __forceinline__ int ghost_src(const BebArgs& p, int qa, int a,
                                         bool& ghost, bool& negate) {
  const int n = p.n[a];
  int mode;
  if (qa == 0) {
    mode = p.ghost[a];
    qa = mode == 0 ? n : 1;
  } else if (qa == n + 1) {
    mode = p.ghost[a + 3];
    qa = mode == 0 ? 1 : n;
  } else {
    return qa;
  }
  ghost = true;
  negate = negate != (mode < 0);
  return qa;
}

// 1 and 4: cB_c - (p1 (e2 up - e2) - p2 (e1 up - e1)), the plain order.
__device__ __forceinline__ float b_update(float b, float pb1, float pb2,
                                          float e2, float e2up, float e1,
                                          float e1up) {
  const float d = fsub(fmul(pb1, fsub(e2up, e2)), fmul(pb2, fsub(e1up, e1)));
  return fsub(b, d);
}

// 3: (new TCA, new E) of component c from cB_{a2} at q and q - a1, cB_{a1}
// at q and q - a2, and TCA, E and jf at q.
__device__ __forceinline__ float2 e_update(const BebArgs& p, int c, float b2,
                                           float b2m, float b1, float b1m,
                                           float tca, float e, float jf) {
  const int a1 = (c + 1) % 3;
  const int a2 = (c + 2) % 3;
  const float curl =
      fsub(fmul(p.pe[a1], fsub(fmul(b2, p.rmu[a2]), fmul(b2m, p.rmu[a2]))),
           fmul(p.pe[a2], fsub(fmul(b1, p.rmu[a1]), fmul(b1m, p.rmu[a1]))));
  const float t = fsub(curl, fmul(p.damp, tca));
  const float en = fadd(fmul(p.decay[c], e),
                        fmul(p.drive[c], fsub(t, fmul(p.cj, jf))));
  return make_float2(t, en);
}

// body(q, v) for this thread's voxels of the whole ghosted grid, a
// grid-stride loop with per-axis carries.
template <typename Body>
__device__ __forceinline__ void grid_voxels(const int N[3], Body&& body) {
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  int stride = gridDim.x * blockDim.x;
  int q0 = first % N[0];
  int q1 = (first / N[0]) % N[1];
  int q2 = first / (N[0] * N[1]);
  const int d0 = stride % N[0];
  stride /= N[0];
  const int d1 = stride % N[1];
  const int d2 = stride / N[1];
  const int sy = N[0], sz = N[0] * N[1];
  while (q2 < N[2]) {
    const int q[3] = {q0, q1, q2};
    body(q, q0 + q1 * sy + q2 * sz);
    q0 += d0;
    int carry = q0 >= N[0];
    if (carry) q0 -= N[0];
    q1 += d1 + carry;
    carry = q1 >= N[1];
    if (carry) q1 -= N[1];
    q2 += d2 + carry;
  }
}

__global__ void field_beb_grid_kernel(BebArgs p) {
  cg::grid_group grid = cg::this_grid();
  const int N[3] = {p.n[0] + 2, p.n[1] + 2, p.n[2] + 2};
  const int st[3] = {1, N[0], N[0] * N[1]};
  auto half_b = [&](const int q[3], int v) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (!in_b(p, q, c)) continue;
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      const float* e1 = p.e[a1];
      const float* e2 = p.e[a2];
      p.b[c][v] = b_update(p.b[c][v], p.pb[a1], p.pb[a2], e2[v],
                           e2[v + st[a1]], e1[v], e1[v + st[a2]]);
    }
  };
  grid_voxels(N, half_b);
  grid.sync();
  grid_voxels(N, [&](const int q[3], int v) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bool ghost = false, negate = false;
      int src = v;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        if (a != c)
          src += (ghost_src(p, q[a], a, ghost, negate) - q[a]) * st[a];
      if (!ghost) continue;
      const float s = p.b[c][src];
      p.b[c][v] = negate ? -s : s;
    }
  });
  grid.sync();
  grid_voxels(N, [&](const int q[3], int v) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (pec_zero(p, q, c)) {
        p.e[c][v] = 0.0f;
        p.tca[c][v] = 0.0f;
        continue;
      }
      if (!in_e(p, q, c)) continue;
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      const float* b1 = p.b[a1];
      const float* b2 = p.b[a2];
      const float2 te =
          e_update(p, c, b2[v], b2[v - st[a1]], b1[v], b1[v - st[a2]],
                   p.tca[c][v], p.e[c][v], p.jf[c][v]);
      p.tca[c][v] = te.x;
      p.e[c][v] = te.y;
    }
  });
  grid.sync();
  grid_voxels(N, half_b);
}

int fill_args(BebArgs& a, float* ex, float* ey, float* ez, float* cbx,
              float* cby, float* cbz, float* tcax, float* tcay, float* tcaz,
              const float* jfx, const float* jfy, const float* jfz, int nx,
              int ny, int nz, const float* coef, const int* faces) {
  if (nx <= 0 || ny <= 0 || nz <= 0) return (int)cudaErrorInvalidValue;
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
  return 0;
}

int finish(cudaError_t err) {
  if (err != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next launch
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The 12 arrays are (nz+2, ny+2, nx+2) float32; coef holds pb[3], pe[3],
// damp, cj, decay[3], drive[3], rmu[3] (17 floats) and faces ghost[6],
// pec[6] (12 ints), as BebArgs.  As many blocks of `threads` as fit on the
// card at once (cooperative launch), at most one per `threads` voxels.
// Returns a cudaError_t code, 0 on success.
extern "C" int field_beb_grid(float* ex, float* ey, float* ez, float* cbx,
                              float* cby, float* cbz, float* tcax,
                              float* tcay, float* tcaz, const float* jfx,
                              const float* jfy, const float* jfz, int nx,
                              int ny, int nz, const float* coef,
                              const int* faces, int threads, void* stream) {
  BebArgs a;
  int rc = fill_args(a, ex, ey, ez, cbx, cby, cbz, tcax, tcay, tcaz, jfx, jfy,
                     jfz, nx, ny, nz, coef, faces);
  if (rc) return rc;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, field_beb_grid_kernel, threads, 0);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return finish(err);
  const long long nvox = (long long)(nx + 2) * (ny + 2) * (nz + 2);
  long long blocks = (nvox + threads - 1) / threads;
  if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  void* args[] = {&a};
  return finish(cudaLaunchCooperativeKernel(
      (const void*)field_beb_grid_kernel, dim3((unsigned)blocks),
      dim3(threads), args, 0, (cudaStream_t)stream));
}

extern "C" const char* field_beb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
