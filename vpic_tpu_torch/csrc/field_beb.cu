// field_beb.cu -- the field trio advance_b(1/2), advance_e, advance_b(1/2),
// written by hand for Hopper (sm_90a) in two instances.
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
// so both instances compute the plain version's floats.
//
// What bounds it on the H100: not bytes (12 arrays read and 9 written, 21 x
// 4 B a voxel: 1.10 MB at the 64^2 harris grid, 0.33 us at 3.35 TB/s) but
// the chain of dependent steps -- a launch, four phases, the barriers
// between them -- on grids of a few thousand warps.
//
// field_beb_grid_kernel, the step's instance at every grid size: one
// cooperative launch; every phase is a grid-stride loop over the voxels
// with 32-bit per-axis coordinates, and the phases are separated by
// grid-wide barriers.  It is kept in one launch rather than split into
// three ordinary launches at its barriers because the step is bound by the
// host's launches (one launch a trio).
//
// field_beb_cluster_kernel, the redesign that was measured against it and
// is not on the step: for grids whose 12 arrays fit into one cluster's
// shared memory (48 B a voxel against 16 x 227 KB: every 2-D grid to 128^2
// and 3-D to 32^3), one ordinary launch of ONE thread-block cluster of up
// to 16 CTAs (a non-portable cluster size, which Hopper takes), one per SM.
// Each CTA owns a slab of whole planes along the grid's slowest non-flat
// axis P (z in 3-D, y in 2-D) and copies its slab of the 12 arrays into
// shared memory with asynchronous 16-byte copies (E and cB first, TCA and
// jf in a second group).  Then:
//   A. phases 1 and 2 with no value of another CTA: a ghost point takes
//      its source's advance_b(1/2) value computed from the inputs (its
//      source is no ghost); what lies on a plane another CTA owns is read
//      from global memory, where the inputs still are; a CTA barrier, and
//      advance_b(1/2) in place;
//   cluster barrier;
//   3. advance_e in shared memory, reading cB on the neighbouring CTA's
//      edge plane through distributed shared memory (map_shared_rank);
//   cluster barrier;
//   4. advance_b(1/2), reading the neighbour's E the same way; then every
//      output of the voxel is stored to global memory once (unchanged
//      values too), after the last barrier that orders memory, so no
//      barrier waits for a global store;
//   a last cluster barrier (relaxed: only for lifetime) keeps every CTA's
//   shared memory alive until no CTA reads it.
// Indices are 32-bit, and a thread walks its voxels by per-axis
// coordinates (no division per voxel or per copy).
// Measured (PERF.md, H100): it is SLOWER than the grid instance at every
// grid it takes (0.011 against 0.008 device ms at 64^2, 0.024 against
// 0.009 at 32^3): a cluster barrier that orders memory compiles to
// MEMBAR.ALL.GPU, and 16 SMs copy the slab in and issue every phase where
// the grid instance spreads them over the card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ---------------------------------------------------------------------------
// The cluster instance
// ---------------------------------------------------------------------------

// How the ghosted grid (N[a] = n[a] + 2 points along axis a) is cut into
// slabs: rank r of the C CTAs owns planes [lo_r, lo_{r+1}) along axis P,
// lo_r = r NP / C.  Global index of q: sum q[a] gst[a].  Shared index of q
// in its owner r: off_r + q[P] inner + sum_{a != P} q[a] lst[a], where the
// axes faster than P keep their global strides, the slower ones stride
// rs (>= the largest slab's planes x inner, and = NP inner mod 4), and
// off_r = s0_r - lo_r inner with s0_r = lo_r inner mod 4: each run of
// a slab that is contiguous in global memory is contiguous in shared
// memory too, at the same address mod 16 bytes.
struct Slab {
  int N[3];
  int np;           // N[P]
  int inner;        // gst[P]
  int outer;        // product of N over the axes slower than P
  int ctas;         // C
  int rs;           // shared stride between the runs of a slab
  int as;           // floats per array in shared memory (a multiple of 4)
  int gst[3];       // global strides
  int lst[3];       // shared strides (lst[P] = inner)
  int aligned;      // bit k: array k (ex .. jfz, as FIELDS) is 16-B aligned
};

struct Own {
  int rank, lo, hi, off;
  int prev_off, next_off;   // the off of the CTAs that own lo - 1 and hi
};

__device__ __forceinline__ int slab_lo(const Slab& s, int r) {
  return r * s.np / s.ctas;
}
__device__ __forceinline__ int slab_off(const Slab& s, int r) {
  const int lo = slab_lo(s, r) * s.inner;
  return (lo & 3) - lo;
}

// The value at plane qp, local index L (without the owner's off), of the
// shared array s: from this CTA's shared memory if it owns the plane, else
// (qp is the plane next to its slab, lo - 1 or hi) from the neighbour's.
__device__ __forceinline__ float at(const float* s, int qp, int L,
                                    const Own& me, cg::cluster_group& cl) {
  if (qp >= me.lo && qp < me.hi) return s[me.off + L];
  const bool next = qp == me.hi;
  const float* rs = cl.map_shared_rank(s, me.rank + (next ? 1 : -1));
  return rs[(next ? me.next_off : me.prev_off) + L];
}

// Asynchronous copies from global into shared memory (no registers held).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// body(q, L, g) for every voxel of this CTA's slab: q its coordinates, L
// its local index (without off), g its global index.  Consecutive threads
// take consecutive x; each thread steps by blockDim.x with per-axis
// carries.
template <int P, typename Body>
__device__ __forceinline__ void own_voxels(const Slab& sl, const Own& me,
                                           Body&& body) {
  int ext[3] = {sl.N[0], sl.N[1], sl.N[2]};
  ext[P] = me.hi - me.lo;
  int t = threadIdx.x;
  int q0 = t % ext[0];
  t /= ext[0];
  int q1 = t % ext[1];
  int q2 = t / ext[1];
  int s = blockDim.x;
  const int d0 = s % ext[0];
  s /= ext[0];
  const int d1 = s % ext[1];
  const int d2 = s / ext[1];
  int lstp[3] = {sl.lst[0], sl.lst[1], sl.lst[2]};
  lstp[P] = sl.inner;
  while (q2 < ext[2]) {
    int q[3] = {q0, q1, q2};
    q[P] += me.lo;
    const int L = q[0] * lstp[0] + q[1] * lstp[1] + q[2] * lstp[2];
    const int g = q[0] * sl.gst[0] + q[1] * sl.gst[1] + q[2] * sl.gst[2];
    body(q, L, g);
    q0 += d0;
    int carry = q0 >= ext[0];
    if (carry) q0 -= ext[0];
    q1 += d1 + carry;
    carry = q1 >= ext[1];
    if (carry) q1 -= ext[1];
    q2 += d2 + carry;
  }
}

// The arrays of BebArgs by index, in FIELDS order.
__device__ __forceinline__ const float* global_array(const BebArgs& p,
                                                     int k) {
  return k < 3 ? p.e[k] : k < 6 ? p.b[k - 3] : k < 9 ? p.tca[k - 6]
                                                     : p.jf[k - 9];
}

template <int P>
__global__ void __launch_bounds__(1024, 1)
    field_beb_cluster_kernel(BebArgs p, Slab sl) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  Own me;
  me.rank = (int)cl.block_rank();
  me.lo = slab_lo(sl, me.rank);
  me.hi = slab_lo(sl, me.rank + 1);
  me.off = slab_off(sl, me.rank);
  me.prev_off = slab_off(sl, me.rank - 1);
  me.next_off = slab_off(sl, me.rank + 1);
  // the 12 arrays in shared memory, in FIELDS order
  float* const se[3] = {smem, smem + sl.as, smem + 2 * sl.as};
  float* const sb[3] = {smem + 3 * sl.as, smem + 4 * sl.as,
                        smem + 5 * sl.as};
  float* const st[3] = {smem + 6 * sl.as, smem + 7 * sl.as,
                        smem + 8 * sl.as};
  const float* const sj[3] = {smem + 9 * sl.as, smem + 10 * sl.as,
                              smem + 11 * sl.as};
  int lstp[3] = {sl.lst[0], sl.lst[1], sl.lst[2]};
  lstp[P] = sl.inner;

  // --- load: this CTA's slab of the 12 arrays, one run of rows x inner
  // floats per array and outer index, as asynchronous copies of aligned
  // 16-byte pieces (4-byte ones at a run's ragged ends): E and cB in one
  // group, TCA and jf (needed from phase 3 on) in a second ---
  {
    const int len = (me.hi - me.lo) * sl.inner;
    const int s0 = me.off + me.lo * sl.inner;
    const int nq = (len + 2) / 4 + 1;   // 16-byte pieces a run can touch
    // piece (j, o, k) of run o of array k; each thread steps by blockDim.x
    // pieces with mixed-radix carries (no division per piece)
    int t = threadIdx.x;
    const int j0 = t % nq;
    t /= nq;
    const int o0 = t % sl.outer;
    const int k0 = t / sl.outer;
    int step = blockDim.x;
    const int dj = step % nq;
    step /= nq;
    const int dO = step % sl.outer;
    const int dk = step / sl.outer;
    for (int half = 0; half < 2; ++half) {
      int j = j0, o = o0, k = k0 + 6 * half;
      while (k < 6 * half + 6) {
        const float* src = global_array(p, k);
        float* dst = smem + k * sl.as;
        const int g = o * sl.np * sl.inner + me.lo * sl.inner;
        const int e0 = ((g >> 2) + j) << 2;
        const int d = s0 + o * sl.rs - (g & 3) + 4 * j;
        if (e0 >= g && e0 + 4 <= g + len && ((sl.aligned >> k) & 1)) {
          cp_async16(dst + d, src + e0);
        } else if (e0 < g + len) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (e0 + i >= g && e0 + i < g + len)
              cp_async4(dst + d + i, src + e0 + i);
        }
        j += dj;
        int carry = j >= nq;
        if (carry) j -= nq;
        o += dO + carry;
        carry = o >= sl.outer;
        if (carry) o -= sl.outer;
        k += dk + carry;
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
  __syncthreads();

  auto owned = [&](int qp) { return qp >= me.lo && qp < me.hi; };
  // INT (1..n) and INTH (1..n+1) along each axis
  auto classify = [&](const int q[3], bool in[3], bool inh[3]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      in[a] = (unsigned)(q[a] - 1) < (unsigned)p.n[a];
      inh[a] = (unsigned)(q[a] - 1) <= (unsigned)p.n[a];
    }
  };
  // Every phase gathers a voxel's inputs for all three components before
  // it computes and stores any: no load waits behind a store it might
  // alias, so the loads of a voxel (shared, distributed shared, global)
  // are in flight together.

  // --- A: advance_b(1/2) and the tangential cB ghosts, with no value of
  // another CTA: what phase A reads on a plane this CTA does not own it
  // reads from global memory, where E and cB are still the trio's inputs.
  // A1: each ghost point takes its source point's advance_b(1/2) value
  // (computed here from the inputs; the source is no ghost, and its own
  // update is A2's, after the CTA barrier below) ---
  // E_k (inputs) at plane qp, local index L, global index g
  auto e_in = [&](int k, int qp, int L, int g) -> float {
    return owned(qp) ? se[k][me.off + L] : p.e[k][g];
  };
  own_voxels<P>(sl, me, [&](const int q[3], int L, int g) {
    bool in[3], inh[3];
    classify(q, in, inh);
    if (in[0] && in[1] && in[2]) return;
    bool ghost[3], negate[3], upd[3];
    float bs[3], e2[3], e2u[3], e1[3], e1u[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      ghost[c] = negate[c] = false;
      int src[3] = {q[0], q[1], q[2]};
#pragma unroll
      for (int a = 0; a < 3; ++a)
        if (a != c) src[a] = ghost_src(p, q[a], a, ghost[c], negate[c]);
      upd[c] = ghost[c] && (unsigned)(src[c] - 1) <= (unsigned)p.n[c];
      bs[c] = e2[c] = e2u[c] = e1[c] = e1u[c] = 0.0f;
      if (!ghost[c]) continue;
      const int Ls = L + (src[0] - q[0]) * lstp[0] +
                     (src[1] - q[1]) * lstp[1] + (src[2] - q[2]) * lstp[2];
      const int gs = g + (src[0] - q[0]) * sl.gst[0] +
                     (src[1] - q[1]) * sl.gst[1] +
                     (src[2] - q[2]) * sl.gst[2];
      const int ps = src[P];
      bs[c] = owned(ps) ? sb[c][me.off + Ls] : p.b[c][gs];
      if (!upd[c]) continue;
      // E_{a2} at src and src + a1, E_{a1} at src and src + a2
      e2[c] = e_in(a2, ps, Ls, gs);
      e2u[c] = e_in(a2, ps + (a1 == P), Ls + lstp[a1], gs + sl.gst[a1]);
      e1[c] = e_in(a1, ps, Ls, gs);
      e1u[c] = e_in(a1, ps + (a2 == P), Ls + lstp[a2], gs + sl.gst[a2]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (!ghost[c]) continue;
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      const float b = upd[c] ? b_update(bs[c], p.pb[a1], p.pb[a2], e2[c],
                                        e2u[c], e1[c], e1u[c])
                             : bs[c];
      sb[c][me.off + L] = negate[c] ? -b : b;
    }
  });
  __syncthreads();

  // A2: advance_b(1/2) in place over each component's extent
  own_voxels<P>(sl, me, [&](const int q[3], int L, int g) {
    bool in[3], inh[3];
    classify(q, in, inh);
    if (!(inh[0] && inh[1] && inh[2])) return;
    const int v = me.off + L;
    float b[3], e[3], eu[3][3];   // eu[k][a]: E_k at q + a
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = sb[c][v];
      e[c] = se[c][v];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      eu[a2][a1] = eu[a1][a2] = 0.0f;
      if (!(in[a1] && in[a2])) continue;
      eu[a2][a1] = e_in(a2, q[P] + (a1 == P), L + lstp[a1], g + sl.gst[a1]);
      eu[a1][a2] = e_in(a1, q[P] + (a2 == P), L + lstp[a2], g + sl.gst[a2]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      if (!(in[a1] && in[a2])) continue;
      sb[c][v] = b_update(b[c], p.pb[a1], p.pb[a2], e[a2], eu[a2][a1],
                          e[a1], eu[a1][a2]);
    }
  });
  // TCA and jf in, then every CTA's cB after A visible to the cluster
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  cl.sync();

  // --- 3: advance_e; E and TCA into shared memory ---
  own_voxels<P>(sl, me, [&](const int q[3], int L, int g) {
    bool in[3], inh[3];
    classify(q, in, inh);
    const int v = me.off + L;
    bool zero[3], upd[3];
    float b[3], bm[3][3], t[3], e[3], j[3];   // bm[k][a]: cB_k at q - a
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      zero[c] = pec_zero(p, q, c);
      upd[c] = !zero[c] && in[c] && inh[a1] && inh[a2];
      b[c] = sb[c][v];
      t[c] = st[c][v];
      e[c] = se[c][v];
      j[c] = sj[c][v];
      bm[a2][a1] = bm[a1][a2] = 0.0f;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      if (!upd[c]) continue;
      bm[a2][a1] = at(sb[a2], q[P] - (a1 == P), L - lstp[a1], me, cl);
      bm[a1][a2] = at(sb[a1], q[P] - (a2 == P), L - lstp[a2], me, cl);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      if (zero[c]) {
        se[c][v] = 0.0f;
        st[c][v] = 0.0f;
      } else if (upd[c]) {
        const float2 te = e_update(p, c, b[a2], bm[a2][a1], b[a1],
                                   bm[a1][a2], t[c], e[c], j[c]);
        st[c][v] = te.x;
        se[c][v] = te.y;
      }
    }
  });
  cl.sync();

  // --- 4: advance_b(1/2); then every output of the voxel to global
  // memory (E and TCA after 3, cB after 4 or after A where 4 leaves it),
  // unchanged values too: no barrier above waited on a global store ---
  own_voxels<P>(sl, me, [&](const int q[3], int L, int g) {
    bool in[3], inh[3];
    classify(q, in, inh);
    const bool inside = inh[0] && inh[1] && inh[2];
    const int v = me.off + L;
    float b[3], e[3], t[3], eu[3][3];   // eu[k][a]: E_k at q + a
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b[c] = sb[c][v];
      e[c] = se[c][v];
      t[c] = st[c][v];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      eu[a2][a1] = eu[a1][a2] = 0.0f;
      if (!(inside && in[a1] && in[a2])) continue;
      eu[a2][a1] = at(se[a2], q[P] + (a1 == P), L + lstp[a1], me, cl);
      eu[a1][a2] = at(se[a1], q[P] + (a2 == P), L + lstp[a2], me, cl);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int a1 = (c + 1) % 3;
      const int a2 = (c + 2) % 3;
      p.e[c][g] = e[c];
      p.tca[c][g] = t[c];
      p.b[c][g] = inside && in[a1] && in[a2]
                      ? b_update(b[c], p.pb[a1], p.pb[a2], e[a2], eu[a2][a1],
                                 e[a1], eu[a1][a2])
                      : b[c];
    }
  });
  // no CTA leaves while another may still read its shared memory (a
  // barrier for lifetime only: nothing written above is read after it)
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The grid instance
// ---------------------------------------------------------------------------

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

typedef void (*ClusterKernel)(BebArgs, Slab);

// The (threads, shared bytes, CTAs) each instance of the cluster kernel
// was last checked to fit with on each device (the attributes are set per
// device), so a trio makes no occupancy query; devices from kMaxDevices on
// are checked on every launch.
struct Fit {
  int threads, smem, ctas;
};
constexpr int kMaxDevices = 64;
Fit fitted[kMaxDevices][3] = {};

template <int P>
int launch_cluster(const BebArgs& a, Slab& sl, int threads,
                   cudaStream_t stream) {
  const ClusterKernel kern = field_beb_cluster_kernel<P>;
  const int smem = 12 * sl.as * (int)sizeof(float);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)sl.ctas);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)sl.ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0;
  cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return finish(derr);
  Fit none = {};
  Fit& fit = dev < kMaxDevices ? fitted[dev][P] : none;
  if (fit.threads != threads || fit.smem != smem || fit.ctas != sl.ctas) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    // above 8 CTAs the cluster is a non-portable size (16 on Hopper)
    if (err == cudaSuccess && sl.ctas > 8)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int clusters = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
    if (err == cudaSuccess && clusters < 1)
      err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) return finish(err);
    fit = Fit{threads, smem, sl.ctas};
  }
  return finish(cudaLaunchKernelEx(&cfg, kern, a, sl));
}

}  // namespace

// The 12 arrays are (nz+2, ny+2, nx+2) float32; coef holds pb[3], pe[3],
// damp, cj, decay[3], drive[3], rmu[3] (17 floats) and faces ghost[6],
// pec[6] (12 ints), as BebArgs.  Each returns a cudaError_t code, 0 on
// success.

// The cluster instance.  plan holds the slab axis P, the CTAs C (1 to 16),
// rs and as (see Slab), as ops/field_fuse.py's cluster_plan computes them.
extern "C" int field_beb_cluster(float* ex, float* ey, float* ez, float* cbx,
                                 float* cby, float* cbz, float* tcax,
                                 float* tcay, float* tcaz, const float* jfx,
                                 const float* jfy, const float* jfz, int nx,
                                 int ny, int nz, const float* coef,
                                 const int* faces, const int* plan,
                                 int threads, void* stream) {
  BebArgs a;
  int rc = fill_args(a, ex, ey, ez, cbx, cby, cbz, tcax, tcay, tcaz, jfx, jfy,
                     jfz, nx, ny, nz, coef, faces);
  if (rc) return rc;
  const int P = plan[0];
  if (P < 0 || P > 2 || plan[1] < 1 || plan[1] > 16)
    return (int)cudaErrorInvalidValue;
  Slab sl;
  for (int k = 0; k < 3; ++k) sl.N[k] = a.n[k] + 2;
  sl.gst[0] = 1;
  sl.gst[1] = sl.N[0];
  sl.gst[2] = sl.N[0] * sl.N[1];
  sl.np = sl.N[P];
  sl.inner = sl.gst[P];
  sl.outer = 1;
  for (int k = P + 1; k < 3; ++k) sl.outer *= sl.N[k];
  sl.ctas = plan[1];
  sl.rs = plan[2];
  sl.as = plan[3];
  int stride = sl.rs;
  for (int k = 0; k < 3; ++k) {
    if (k < P) {
      sl.lst[k] = sl.gst[k];
    } else if (k == P) {
      sl.lst[k] = sl.inner;
    } else {
      sl.lst[k] = stride;
      stride *= sl.N[k];
    }
  }
  const int rows = (sl.np + sl.ctas - 1) / sl.ctas;
  if (sl.np < sl.ctas || sl.rs < rows * sl.inner ||
      (sl.rs - sl.np * sl.inner) % 4 != 0 || sl.as % 4 != 0 ||
      sl.as < 3 + sl.outer * sl.rs)
    return (int)cudaErrorInvalidValue;
  const float* arrays[12] = {ex,   ey,   ez,   cbx, cby, cbz,
                             tcax, tcay, tcaz, jfx, jfy, jfz};
  sl.aligned = 0;
  for (int k = 0; k < 12; ++k)
    if ((reinterpret_cast<uintptr_t>(arrays[k]) & 15) == 0)
      sl.aligned |= 1 << k;
  const cudaStream_t s = (cudaStream_t)stream;
  if (P == 0) return launch_cluster<0>(a, sl, threads, s);
  if (P == 1) return launch_cluster<1>(a, sl, threads, s);
  return launch_cluster<2>(a, sl, threads, s);
}

// The grid instance: as many blocks of `threads` as fit on the card at once
// (cooperative launch), at most one per `threads` voxels.
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
