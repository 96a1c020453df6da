// ta_collide.cu -- the Takizuka-Abe binary collision op, written by hand for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: vpic_tpu/collision.py runs the binary ops in plain
// jnp, and so does the plain PyTorch version beside this file,
// vpic_tpu_torch/collision.py::make_binary_op's apply_plain (a radix sort of
// every slot, nine column gathers, two searchsorted calls, ~100 elementwise
// launches over the pairs and, between species, an index_add_ into the
// j-lanes that every dead i-lane hits at voxel 0's lanes): ~682 launches and
// 12.5 device ms a firing of the collisional reconnection deck's three ops at
// 32^3 x 128 ppc (PERF.md).  On CUDA tensors the op's apply runs this file.
//
// One op is an order pass for each species it shuffles, then one pair kernel.
//
// The order pass (six launches, after a zeroing) gives shuffle_sort's
// permutation bit for bit, a stable sort by (voxel, key) with dead lanes last
// and key ties broken by slot, and cell_partition's voxel starts, with no sort
// of the whole species.  A lane's segment is
//     live:  voxel << sub | key >> (31 - sub)    (a voxel's sub-buckets)
//     dead:  (nv << sub) + (key >> (31 - dead))  (dead buckets, after all)
// Segments split each voxel, and the dead lanes, by the key's top bits, so
// segment order is (voxel, key) order, and within a segment the lanes go by
// (key, slot).  The wrapper (ops/ta_collide.py::segment_bits) picks sub and
// dead from the lanes a voxel and the capacity, so a segment holds 16 lanes
// or fewer on average with every slot live.
//   1. count: a thread a slot adds one to its segment's count, one atomic a
//      group of a warp's lanes in one segment (__match_any_sync);
//   2. tiles: a block a tile of SCAN_TILE segments sums their counts;
//   3. scan: a block a tile: the tiles below it give its base, a block scan
//      the exclusive starts (start[nseg] = n); a segment of more than CAP
//      lanes goes on the wide list, and its lanes add to the wide counts;
//   4. place: a thread a slot writes (key << 32 | slot) and its segment to
//      the next free place of its segment (a warp group's places from one
//      atomic), in no particular order inside the segment;
//   5. rank: a block a window of WINDOW places loads the whole segments of
//      its first and last places and everything between into shared memory;
//      a lane's rank in its segment is the count of its segment's keys below
//      its own, and order[start + rank] = slot.  Segments past CAP are left;
//   6. wide: a block a wide segment (none in the runs measured) sorts it in
//      device memory: chunks of CAP ranked in shared memory, then merge
//      passes, each place found by a binary search in the partner run.  The
//      first block copies the wide counts to mapped host memory.
// Nothing is read on the host: the wide path is the device's decision.
//
// The pair kernel reads every lane through the order, so the species are
// gathered and collided in one pass and each output row is written once:
//   within a species, a thread a pair of places (2m, 2m + 1): a pair in one
//   voxel, both live, collides; every other row is the gathered row;
//   between species, a thread a j-place q: a live j-lane of rank r in its
//   voxel collides with the i-lanes of ranks r, r + n_j, ... < n_i (the plain
//   op's r mod n_j rule read from the j side), writes their rows and adds
//   their j-changes in place order, as index_add_ on the CPU adds them; the
//   same thread writes i-place q when no j-lane takes it (dead, or its voxel
//   holds no j-lane) as the gathered row.  No atomics: the j-side sums are
//   deterministic, and dead lanes add nothing.
// Dead rows come out with voxel 0, as gather_sp_rows leaves them.  Every
// change is computed from the pre-collision momenta, in float32 in the plain
// op's operation order, with no contraction into fused multiply-adds
// (__fmul_rn and kin), and with the functions torch's CUDA kernels call
// (sqrtf, rsqrtf, cosf, sinf, IEEE division): the plain op on the card gives
// the same momenta, but for the j sums' order and the sign of a zero change
// on a lane that does not collide.
//
// What bounds it on the H100: bytes, and the gathers' sectors.  At 32^3 x 128
// ppc a species pass reads 9 bytes a slot twice and moves 12 bytes a slot of
// (key, slot, segment) to the rank pass; the pair kernel gathers 33 bytes a
// slot and writes them, and reads 16 bytes of variates a pair.  The gathers
// touch a 32-byte sector for each 4-byte word (a voxel's lanes lie near each
// other after the relayout, so most come from the 50 MB L2; the ~1M dead
// lanes, in random key order, do not), and the place pass scatters.  A firing
// of the reconnection deck's three ops took 0.404 device ms a step (2.02 a
// firing with the draws) in the graphed step against the 0.110 ms a firing
// its bytes bound it to, and against 2.504 (12.5) for the plain op (NVIDIA
// H100 80GB HBM3, 700 W; PERF.md).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 without
// --use_fast_math.  Each entry point returns the first launch error.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WINDOW = 1024;     // places a block of the rank pass takes
constexpr int CAP = 1024;        // lanes of a segment ranked in shared memory
constexpr int SCAN_TILE = 4 * THREADS;  // segments a block of the scan takes
constexpr int WIDE_GRID = 32;    // blocks of the wide pass
constexpr unsigned FULL = 0xffffffffu;

using u64 = unsigned long long;

struct OrderArgs {
  const unsigned char* live;  // (n,)
  const int* vox;             // (n,)
  const int* key;             // (n,) 31-bit shuffle keys
  int n, nv, sub, dead, nseg, ntiles, nwide_max;
  int* count;       // (nseg,) zeroed
  int* wide_n;      // (1,) zeroed
  int* tile_sum;    // (ntiles,)
  int* start;       // (nseg + 1,)
  int* fill;        // (nseg,)
  int* wide_seg;    // (nwide_max,)
  u64* tmp;         // (n,) key << 32 | slot, by segment
  int* seg_of;      // (n,) the segment of each place
  int* order;       // (n,) output: place -> slot
  long long* wide;       // (2,) wide lanes live, dead: device counters
  long long* wide_host;  // (2,) their mapped host copy
};

// A lane's segment (see the file's head).  A live lane's voxel is clamped
// to the grid and a key's bits past 31 are dropped, so that no input writes
// out of bounds; valid lanes and keys are left as they are.
__device__ __forceinline__ int segment(const OrderArgs& a, int s) {
  const unsigned k = (unsigned)a.key[s];
  if (a.live[s]) {
    const unsigned v = min((unsigned)a.vox[s], (unsigned)a.nv - 1u);
    const unsigned sub = (k >> (31 - a.sub)) & ((1u << a.sub) - 1u);
    return (int)((v << a.sub) | sub);
  }
  const unsigned d = (k >> (31 - a.dead)) & ((1u << a.dead) - 1u);
  return (a.nv << a.sub) + (int)d;
}

__global__ void __launch_bounds__(THREADS)
    ta_count_kernel(const __grid_constant__ OrderArgs a) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  const int seg = s < a.n ? segment(a, s) : -1;
  const unsigned peers = __match_any_sync(FULL, seg);
  if (seg >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(a.count + seg, __popc(peers));
}

__global__ void __launch_bounds__(THREADS)
    ta_tiles_kernel(const __grid_constant__ OrderArgs a) {
  const int t0 = blockIdx.x * SCAN_TILE;
  int v = 0;
  for (int k = threadIdx.x; k < SCAN_TILE; k += THREADS)
    if (t0 + k < a.nseg) v += a.count[t0 + k];
  int total;
  vpic_scan::block_excl_sum<THREADS>(v, &total);
  if (threadIdx.x == 0) a.tile_sum[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS)
    ta_scan_kernel(const __grid_constant__ OrderArgs a) {
  const int t = threadIdx.x;
  int below = 0;
  for (int q = t; q < (int)blockIdx.x; q += THREADS) below += a.tile_sum[q];
  int base;
  vpic_scan::block_excl_sum<THREADS>(below, &base);
  const int s0 = blockIdx.x * SCAN_TILE + 4 * t;
  int c[4];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    c[j] = s0 + j < a.nseg ? a.count[s0 + j] : 0;
    mine += c[j];
  }
  __syncthreads();
  int all;
  int pos = base + vpic_scan::block_excl_sum<THREADS>(mine, &all);
  long long wl = 0, wd = 0;
  const int dead0 = a.nv << a.sub;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = s0 + j;
    if (s >= a.nseg) break;
    a.start[s] = pos;
    a.fill[s] = pos;
    if (c[j] > CAP) {
      a.wide_seg[min(atomicAdd(a.wide_n, 1), a.nwide_max - 1)] = s;
      if (s < dead0) wl += c[j];
      else wd += c[j];
    }
    pos += c[j];
    if (s == a.nseg - 1) a.start[a.nseg] = pos;
  }
  if (wl) atomicAdd((u64*)a.wide, (u64)wl);
  if (wd) atomicAdd((u64*)a.wide + 1, (u64)wd);
}

__global__ void __launch_bounds__(THREADS)
    ta_place_kernel(const __grid_constant__ OrderArgs a) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  const int seg = s < a.n ? segment(a, s) : -1;
  const unsigned peers = __match_any_sync(FULL, seg);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (seg >= 0 && lane == leader) base = atomicAdd(a.fill + seg, __popc(peers));
  base = __shfl_sync(FULL, base, leader);
  if (seg < 0) return;
  const int pos = base + __popc(peers & ((1u << lane) - 1u));
  a.tmp[pos] = ((u64)(unsigned)a.key[s] << 32) | (unsigned)s;
  a.seg_of[pos] = seg;
}

__global__ void __launch_bounds__(THREADS)
    ta_rank_kernel(const __grid_constant__ OrderArgs a) {
  __shared__ u64 sk[WINDOW + 2 * CAP];
  const int w0 = blockIdx.x * WINDOW;
  const int w1 = min(w0 + WINDOW, a.n);
  // the whole segments of the window's first and last places, unless wide
  const int sl = a.seg_of[w0];
  const int sh = a.seg_of[w1 - 1];
  const int al = a.start[sl], bl = a.start[sl + 1];
  const int ah = a.start[sh], bh = a.start[sh + 1];
  const int lo = bl - al > CAP ? bl : al;
  const int hi = bh - ah > CAP ? ah : bh;
  for (int x = lo + threadIdx.x; x < hi; x += THREADS) sk[x - lo] = a.tmp[x];
  __syncthreads();
  for (int p = w0 + threadIdx.x; p < w1; p += THREADS) {
    const int seg = a.seg_of[p];
    const int b0 = a.start[seg], b1 = a.start[seg + 1];
    if (b1 - b0 > CAP) continue;
    const u64 k = sk[p - lo];
    int rank = 0;
    for (int y = b0 - lo; y < b1 - lo; ++y) rank += sk[y] < k;
    a.order[b0 + rank] = (int)(unsigned)k;
  }
}

// the wide pass's second buffer: the segment's places in order (low word)
// and seg_of (high word), free once the rank pass has run
__device__ __forceinline__ u64 pair_load(const OrderArgs& a, int x) {
  return ((u64)(unsigned)a.seg_of[x] << 32) | (unsigned)a.order[x];
}

__device__ __forceinline__ void pair_store(const OrderArgs& a, int x, u64 k) {
  a.order[x] = (int)(unsigned)k;
  a.seg_of[x] = (int)(unsigned)(k >> 32);
}

__global__ void __launch_bounds__(THREADS)
    ta_wide_kernel(const __grid_constant__ OrderArgs a) {
  __shared__ u64 sk[CAP];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.wide_host[0] = a.wide[0];
    a.wide_host[1] = a.wide[1];
  }
  const int nw = min(*a.wide_n, a.nwide_max);
  for (int w = blockIdx.x; w < nw; w += gridDim.x) {
    const int seg = a.wide_seg[w];
    const int b0 = a.start[seg];
    const int n = a.start[seg + 1] - b0;
    u64* A = a.tmp + b0;
    // sorted runs of CAP in A
    for (int c0 = 0; c0 < n; c0 += CAP) {
      const int m = min(CAP, n - c0);
      __syncthreads();
      for (int x = threadIdx.x; x < m; x += THREADS) sk[x] = A[c0 + x];
      __syncthreads();
      for (int x = threadIdx.x; x < m; x += THREADS) {
        const u64 k = sk[x];
        int rank = 0;
        for (int y = 0; y < m; ++y) rank += sk[y] < k;
        A[c0 + rank] = k;
      }
    }
    // merge passes, A and the pair buffer in turn; keys are unique (slots)
    bool in_a = true;
    for (int width = CAP; width < n; width *= 2) {
      __syncthreads();
      for (int x = threadIdx.x; x < n; x += THREADS) {
        const u64 k = in_a ? A[x] : pair_load(a, b0 + x);
        const int r0 = x / width * width;
        const int o0 = r0 ^ width;  // the partner run (width a power of two
                                    // times CAP, r0 a multiple of width)
        int pos = x;
        if (o0 < n) {
          int lo = o0, hi = min(o0 + width, n);
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            const u64 v = in_a ? A[mid] : pair_load(a, b0 + mid);
            if (v < k) lo = mid + 1;
            else hi = mid;
          }
          pos = min(r0, o0) + (x - r0) + (lo - o0);
        }
        if (in_a) pair_store(a, b0 + pos, k);
        else A[pos] = k;
      }
      in_a = !in_a;
    }
    __syncthreads();
    if (in_a)
      for (int x = threadIdx.x; x < n; x += THREADS)
        a.order[b0 + x] = (int)(unsigned)A[x];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the pairs

struct Lanes {
  const float *dx, *dy, *dz, *ux, *uy, *uz, *w;
  const int* vox;
  const unsigned char* live;
};

struct OutLanes {
  float *dx, *dy, *dz, *ux, *uy, *uz, *w;
  int* vox;
  unsigned char* live;
};

struct PairArgs {
  Lanes si, sj;
  OutLanes oi, oj;
  const int *order_i, *order_j;  // place -> slot
  const int *start_i, *start_j;  // segment starts (the order passes')
  int sub_i, sub_j;              // their sub-bucket bits
  const float *pr, *phi, *theta, *bal;  // the op's variates
  int ni, nj;
  float dtint_dv, sample, cvac, var_c, fi, fj, two_pi;
};

// float32 arithmetic in one rounding each, never contracted
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }
// torch.clamp's: NaN stays NaN (v != v only for a NaN)
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
// torch.maximum / minimum: NaN if either is
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a || b != b ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a || b != b ? a + b : fminf(a, b);
}

struct Row {
  float dx, dy, dz, ux, uy, uz, w;
  int vox;
  bool live;
};

// slot s of a species as gather_sp_rows gives it: voxel 0 when dead
__device__ __forceinline__ Row load_row(const Lanes& L, int s) {
  Row r;
  r.live = L.live[s] != 0;
  r.vox = r.live ? L.vox[s] : 0;
  r.dx = L.dx[s];
  r.dy = L.dy[s];
  r.dz = L.dz[s];
  r.ux = L.ux[s];
  r.uy = L.uy[s];
  r.uz = L.uz[s];
  r.w = L.w[s];
  return r;
}

__device__ __forceinline__ void store_row(const OutLanes& O, int q,
                                          const Row& r) {
  O.dx[q] = r.dx;
  O.dy[q] = r.dy;
  O.dz[q] = r.dz;
  O.ux[q] = r.ux;
  O.uy[q] = r.uy;
  O.uz[q] = r.uz;
  O.w[q] = r.w;
  O.vox[q] = r.vox;
  O.live[q] = r.live;
}

// the live lanes of voxel v: [first, first + count)
__device__ __forceinline__ int2 voxel_lanes(const int* start, int sub, int v) {
  const int a = start[v << sub];
  return make_int2(a, start[(v + 1) << sub] - a);
}

struct Kick {
  float ix, iy, iz, jx, jy, jz;  // fi * d, -fj * d
};

// One candidate pair of a T&A op (collision.py's one_round for a pair with
// ``same`` true, T&A's rate and angle, _deflect, the detailed balance).
__device__ Kick collide(const PairArgs& p, const Row& a, const Row& b,
                        float pr_norm, int m) {
  const float urx = fsub(a.ux, b.ux), ury = fsub(a.uy, b.uy),
              urz = fsub(a.uz, b.uz);
  const float ur2 = fadd(fadd(fmul(urx, urx), fmul(ury, ury)), fmul(urz, urz));
  const float ur = fmul(sqrtf(ur2), p.cvac);
  const float w_max = max_nan(a.w, b.w), w_min = min_nan(a.w, b.w);
  const float pr = fmul(fmul(w_max, pr_norm), 1e30f);
  const bool hit = p.pr[m] < pr;
  // tan(theta / 2) = delta ~ N(0, var), var = var_c / v_r^3
  const float mm = clamp_min(ur, 1e-12f);
  const float var = fdiv(p.var_c, fmul(fmul(mm, mm), mm));
  float delta = fmul(sqrtf(var), p.theta[m]);
  delta = ur > 1e-12f ? clamp_nan(delta, -1e3f, 1e3f) : 0.0f;
  const float d2 = fmul(delta, delta);
  const float cos_t = fdiv(fsub(1.0f, d2), fadd(1.0f, d2));
  const float sin_t = fdiv(fmul(2.0f, delta), fadd(1.0f, d2));
  const float phi = fmul(p.phi[m], p.two_pi);
  const float pc = cosf(phi), ps = sinf(phi);
  // _deflect: T1 perpendicular to ur, T2 = ur x T1 / |ur|
  const float urd = sqrtf(ur2);
  const float ax = fabsf(urx), ay = fabsf(ury), az = fabsf(urz);
  const bool min_x = (ax <= ay) && (ax <= az);
  const bool min_y = !min_x && (ay <= az);
  const float tx = min_x ? 0.0f : (min_y ? -urz : -ury);
  const float ty = min_x ? -urz : (min_y ? 0.0f : urx);
  const float tz = min_x ? ury : (min_y ? urx : 0.0f);
  const float tn = rsqrtf(
      clamp_min(fadd(fadd(fmul(tx, tx), fmul(ty, ty)), fmul(tz, tz)), 1e-30f));
  const float t1x = fmul(tx, tn), t1y = fmul(ty, tn), t1z = fmul(tz, tn);
  const float inv = rsqrtf(clamp_min(fmul(urd, urd), 1e-30f));
  const float t2x = fmul(fsub(fmul(ury, t1z), fmul(urz, t1y)), inv);
  const float t2y = fmul(fsub(fmul(urz, t1x), fmul(urx, t1z)), inv);
  const float t2z = fmul(fsub(fmul(urx, t1y), fmul(ury, t1x)), inv);
  const float px = fadd(fmul(pc, t1x), fmul(ps, t2x));
  const float py = fadd(fmul(pc, t1y), fmul(ps, t2y));
  const float pz = fadd(fmul(pc, t1z), fmul(ps, t2z));
  const float cm1 = fsub(cos_t, 1.0f), sur = fmul(sin_t, urd);
  const float dx = fadd(fmul(cm1, urx), fmul(sur, px));
  const float dy = fadd(fmul(cm1, ury), fmul(sur, py));
  const float dz = fadd(fmul(cm1, urz), fmul(sur, pz));
  // detailed balance: the lighter always, the heavier with w_min / w_max
  const bool heavy = fmul(p.bal[m], w_max) < w_min;
  const float fi = hit && (a.w <= b.w || heavy) ? p.fi : 0.0f;
  const float fj = hit && (b.w <= a.w || heavy) ? p.fj : 0.0f;
  Kick k;
  k.ix = fmul(fi, dx);
  k.iy = fmul(fi, dy);
  k.iz = fmul(fi, dz);
  k.jx = fmul(-fj, dx);
  k.jy = fmul(-fj, dy);
  k.jz = fmul(-fj, dz);
  return k;
}

// within a species: a thread a pair of places (2m, 2m + 1), and the last
// place alone when the capacity is odd
__global__ void __launch_bounds__(THREADS)
    ta_intra_kernel(const __grid_constant__ PairArgs p) {
  const int m = blockIdx.x * THREADS + threadIdx.x;
  const int q = 2 * m;
  if (q >= p.ni) return;
  if (q + 1 == p.ni) {
    store_row(p.oi, q, load_row(p.si, p.order_i[q]));
    return;
  }
  const int2 s = *reinterpret_cast<const int2*>(p.order_i + q);
  Row a = load_row(p.si, s.x);
  Row b = load_row(p.si, s.y);
  if (a.live && b.live && a.vox == b.vox) {
    const float nk = (float)voxel_lanes(p.start_i, p.sub_i, a.vox).y;
    const float half_nk = fmul(0.5f, nk);
    const float npairs = fmul(half_nk, fadd(nk, 1.0f));
    const float ncand = clamp_min(fmul(half_nk, p.sample), 1.0f);
    const float pr_norm = fdiv(fmul(p.dtint_dv, npairs), ncand);
    const Kick k = collide(p, a, b, pr_norm, m);
    const float aux = a.ux, auy = a.uy, auz = a.uz;
    a.ux = fadd(aux, k.ix);
    a.uy = fadd(auy, k.iy);
    a.uz = fadd(auz, k.iz);
    b.ux = fadd(b.ux, k.jx);
    b.uy = fadd(b.uy, k.jy);
    b.uz = fadd(b.uz, k.jz);
  }
  store_row(p.oi, q, a);
  store_row(p.oi, q + 1, b);
}

// between species: thread q takes j-place q with its i-partners, and
// i-place q when no j-lane takes it
__global__ void __launch_bounds__(THREADS)
    ta_inter_kernel(const __grid_constant__ PairArgs p) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q < p.nj) {
    Row b = load_row(p.sj, p.order_j[q]);
    if (b.live) {
      const int2 lj = voxel_lanes(p.start_j, p.sub_j, b.vox);
      const int2 li = voxel_lanes(p.start_i, p.sub_i, b.vox);
      const float pr_norm = fdiv(fmul(p.dtint_dv, (float)lj.y), p.sample);
      float ux = b.ux, uy = b.uy, uz = b.uz;
      for (int k = q - lj.x; k < li.y; k += lj.y) {
        const int qi = li.x + k;
        Row a = load_row(p.si, p.order_i[qi]);
        const Kick kk = collide(p, a, b, pr_norm, qi);
        a.ux = fadd(a.ux, kk.ix);
        a.uy = fadd(a.uy, kk.iy);
        a.uz = fadd(a.uz, kk.iz);
        store_row(p.oi, qi, a);
        ux = fadd(ux, kk.jx);
        uy = fadd(uy, kk.jy);
        uz = fadd(uz, kk.jz);
      }
      b.ux = ux;
      b.uy = uy;
      b.uz = uz;
    }
    store_row(p.oj, q, b);
  }
  if (q < p.ni) {
    // the row is gathered only when no j-lane takes it
    const int s = p.order_i[q];
    if (!p.si.live[s] || voxel_lanes(p.start_j, p.sub_j, p.si.vox[s]).y == 0)
      store_row(p.oi, q, load_row(p.si, s));
  }
}

}  // namespace

// One order pass.  ptrs: live vox key count wide_n tile_sum start fill
// wide_seg tmp seg_of order wide wide_host (wide_host the device pointer of
// ta_collide_host_counts' memory); ints: n nv sub dead nseg ntiles
// nwide_max.  count and wide_n are zeroed by the caller.
extern "C" int ta_order(void* const* ptrs, const int* ints, void* stream) {
  OrderArgs a;
  int b = 0;
  a.live = (const unsigned char*)ptrs[b++];
  a.vox = (const int*)ptrs[b++];
  a.key = (const int*)ptrs[b++];
  a.count = (int*)ptrs[b++];
  a.wide_n = (int*)ptrs[b++];
  a.tile_sum = (int*)ptrs[b++];
  a.start = (int*)ptrs[b++];
  a.fill = (int*)ptrs[b++];
  a.wide_seg = (int*)ptrs[b++];
  a.tmp = (u64*)ptrs[b++];
  a.seg_of = (int*)ptrs[b++];
  a.order = (int*)ptrs[b++];
  a.wide = (long long*)ptrs[b++];
  a.wide_host = (long long*)ptrs[b++];
  int d = 0;
  a.n = ints[d++];
  a.nv = ints[d++];
  a.sub = ints[d++];
  a.dead = ints[d++];
  a.nseg = ints[d++];
  a.ntiles = ints[d++];
  a.nwide_max = ints[d++];
  if (a.n < 1 || a.nv < 1 || a.sub < 0 || a.sub > 30 || a.dead < 0 ||
      a.dead > 30 || a.nwide_max < 1 ||
      a.ntiles != (a.nseg + SCAN_TILE - 1) / SCAN_TILE)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int lanes = (a.n + THREADS - 1) / THREADS;
  cudaError_t e;
  ta_count_kernel<<<lanes, THREADS, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ta_tiles_kernel<<<a.ntiles, THREADS, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ta_scan_kernel<<<a.ntiles, THREADS, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ta_place_kernel<<<lanes, THREADS, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ta_rank_kernel<<<(a.n + WINDOW - 1) / WINDOW, THREADS, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ta_wide_kernel<<<WIDE_GRID, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// One pair kernel.  lanes: the nine columns of species i, of j, of the
// output i and of the output j (dx dy dz ux uy uz w i live each; j's are
// null within a species); ptrs: order_i order_j start_i start_j pr phi theta
// bal; ints: ni nj sub_i sub_j intra; floats: dtint_dv sample cvac var_c fi
// fj two_pi.
extern "C" int ta_pair(void* const* lanes, void* const* ptrs, const int* ints,
                       const float* floats, void* stream) {
  PairArgs p;
  Lanes* ins[2] = {&p.si, &p.sj};
  OutLanes* outs[2] = {&p.oi, &p.oj};
  int b = 0;
  for (int k = 0; k < 2; ++k) {
    Lanes& L = *ins[k];
    L.dx = (const float*)lanes[b++];
    L.dy = (const float*)lanes[b++];
    L.dz = (const float*)lanes[b++];
    L.ux = (const float*)lanes[b++];
    L.uy = (const float*)lanes[b++];
    L.uz = (const float*)lanes[b++];
    L.w = (const float*)lanes[b++];
    L.vox = (const int*)lanes[b++];
    L.live = (const unsigned char*)lanes[b++];
  }
  for (int k = 0; k < 2; ++k) {
    OutLanes& O = *outs[k];
    O.dx = (float*)lanes[b++];
    O.dy = (float*)lanes[b++];
    O.dz = (float*)lanes[b++];
    O.ux = (float*)lanes[b++];
    O.uy = (float*)lanes[b++];
    O.uz = (float*)lanes[b++];
    O.w = (float*)lanes[b++];
    O.vox = (int*)lanes[b++];
    O.live = (unsigned char*)lanes[b++];
  }
  b = 0;
  p.order_i = (const int*)ptrs[b++];
  p.order_j = (const int*)ptrs[b++];
  p.start_i = (const int*)ptrs[b++];
  p.start_j = (const int*)ptrs[b++];
  p.pr = (const float*)ptrs[b++];
  p.phi = (const float*)ptrs[b++];
  p.theta = (const float*)ptrs[b++];
  p.bal = (const float*)ptrs[b++];
  p.ni = ints[0];
  p.nj = ints[1];
  p.sub_i = ints[2];
  p.sub_j = ints[3];
  const bool intra = ints[4] != 0;
  int f = 0;
  p.dtint_dv = floats[f++];
  p.sample = floats[f++];
  p.cvac = floats[f++];
  p.var_c = floats[f++];
  p.fi = floats[f++];
  p.fj = floats[f++];
  p.two_pi = floats[f++];
  if (p.ni < 1 || (!intra && p.nj < 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (intra) {
    const int pairs = p.ni / 2 + 1;
    ta_intra_kernel<<<(pairs + THREADS - 1) / THREADS, THREADS, 0, st>>>(p);
  } else {
    const int rows = p.ni > p.nj ? p.ni : p.nj;
    ta_inter_kernel<<<(rows + THREADS - 1) / THREADS, THREADS, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

// n zeroed counts in mapped, page-locked host memory: *host is the host's
// pointer to them, *device the kernels'.  Never freed (one a device and
// process).
extern "C" int ta_collide_host_counts(int n, void** host, void** device) {
  cudaError_t e = cudaHostAlloc(host, (size_t)n * sizeof(long long),
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  for (int k = 0; k < n; ++k) ((long long*)*host)[k] = 0;
  return (int)cudaHostGetDevicePointer(device, *host, 0);
}

extern "C" const char* ta_collide_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
