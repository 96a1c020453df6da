// res_plan.cu -- the residency plan, written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: vpic_tpu/ops/residency.py plans the exchange in
// plain jnp (block_counts, plan_exchange, any_misplaced), and so does the
// plain PyTorch twin of this file, vpic_tpu_torch/ops/residency.py::
// plan_ref.  That plain version is ~115 small torch ops a step (int64 copies
// of whole lane arrays, brick_of as ten elementwise passes, a full radix sort
// of 8-bit keys); on the 32^3 x 128 ppc harris deck they took 0.65 of the
// graphed step's 2.07 device ms (PERF.md).
//
// Four launches a plan, for every species together (MAX_SPECIES; the species
// table is a __grid_constant__ parameter), on the stream's order alone:
//   1. lanes: one CUDA block of 64 threads per 1024-lane layout block.  Each
//      thread loads its 16 lanes' live and emit marks with one 16-byte load
//      each and their voxels with four, all before any other work, so that
//      up to ~200 KB of loads can be in flight on an SM.  The block's free
//      slots after the merge, BLOCK - (live - emitted), become its capacity
//      for newcomers (0 on an unusable block, else clamped to [0, inb]); a
//      live, kept lane whose brick (brick_of's arithmetic on the voxel
//      strides and brick sides, in int32) is not the block's home marks the
//      block misplaced.  The pass also zeroes the key counts that launch 2 adds
//      to, and writes each key's first layout block: the keys after the
//      previous block's key up to this block's start here.
//   2. tiles: one CUDA block per tile of G layout blocks' outbox rows.  A
//      valid row's key is spid * nb + clamp(brick_of(max(vox, 1))).  The
//      tile's rows go through in chunks of 128, one warp after another;
//      __match_any_sync groups a warp's rows by key, so each valid row gets
//      its rank among the tile's earlier rows of its key from a shared
//      counter a key.  The tile's counts go to the key-major histogram
//      (nkey x ntiles) and are added to the key's total.
//   3. keys: one CUDA block per key.  seg[k] is the sum of the totals below
//      k; an exclusive scan of the key's histogram row over the tiles turns
//      each count into the position of the tile's first row of that key.
//      Then the layout blocks whose key (spid * nb + home, nondecreasing
//      along the blocks) is k, from the first-block table: a scan of their
//      capacities gives each its q = min(c_k, capacity before it),
//      a_j = max(min(cap_j, c_k - q), 0) and starts_j = seg[k] + q, and the
//      key's shortfall c_k - capsum_k.
//   4. scatter: a thread an outbox row copies a valid row's 7 floats and
//      voxel to its position, the histogram's tile position plus its rank,
//      when that lies inside the compact rows; the compact valid marks are
//      position < routed total.  The grid's last block reduces the
//      shortfalls and misplaced marks into stats, overflow (a shortfall, or
//      more rows than maxin), misplaced and the rebuild bool
//      (overflow | ores > 0 | misplaced); where it holds, it adds one to the
//      count of the rebucket's cause, the first of leavers past an outbox
//      (ores > 0), an exchange overflow and misplaced lanes alone, in device
//      memory, and writes the count through to a mapped host copy, which the
//      host reads with no copy on the device (res_plan_host_counts).
// The order is that of a stable sort of the rows by key (torch.sort(stable=
// True) in plan_exchange): keys first, then tiles in row order, then the
// rank inside the tile.  Every output is bit for bit the plain version's;
// compact rows past the routed total are left unwritten (the merge reads
// only rows [starts_j, starts_j + a_j), inside the routed prefix).
// Scratch grows with rows + blocks + keys: with G >= nkey / out_cap the
// histogram holds at most rows + nkey words.
//
// What bounds it on the H100: bytes.  At the 32^3 x 128 ppc harris deck the
// lane pass reads 6 bytes of each of 4.85M slots (29 MB), the outbox passes
// 5 bytes of each of 606,208 rows twice, and ~180k routed rows move 32 bytes
// each way: ~44 MB, 0.013 ms at 3.35 TB/s.  The lane state was written by
// the push just before, so some of it may still sit in the 50 MB L2.  The
// four kernels took 0.041-0.043 device ms a step in the graphed step, the
// lane pass 0.016 of it, against 0.665 ms in 163 launches for the plain
// version (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 without
// --use_fast_math.  The entry point returns the first launch error.

#include <climits>
#include <cstring>

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

using vpic_scan::BLOCK;

constexpr int LANE_THREADS = 64;
constexpr int LPT = BLOCK / LANE_THREADS;  // lanes a thread in the lane pass
static_assert(LPT == 16, "a thread loads 16 bytes of each mark array");
constexpr int TILE_THREADS = 128;          // rows a chunk in the tile pass
constexpr int AHEAD = 8;                   // chunks whose rows load at once
constexpr int KEY_THREADS = 256;
constexpr int ROW_THREADS = 256;
constexpr int MAX_SPECIES = 32;
constexpr int NF = 7;  // outbox floats: dx dy dz ux uy uz w
constexpr unsigned FULL = 0xffffffffu;

struct PlanSpecies {
  const unsigned char* live;  // (n,)
  const unsigned char* emit;  // (n,)
  const int* vox;             // (n,)
  const int* home;            // (nblk,)
  int n;                      // lanes
  int nblk;                   // layout blocks, ceil(n / BLOCK)
  int j0;                     // its first layout block among all species'
  int spid;                   // its species index in the keys
};

struct PlanArgs {
  PlanSpecies sp[MAX_SPECIES];
  int nsp;
  // the voxel strides with their division magic (div_by), the brick
  // sides' log2 and the bricks a row and a plane
  int sy, sz;
  unsigned my, mz;
  int s1y, s2y, s1z, s2z;
  int lbx, lby, lbz, nbx, nby, nb;
  // the plan's sizes
  int nkey, nblocks, out_cap, g, ntiles, rows, inb, maxin, ncompact;
  // inputs
  const unsigned char* usable;  // (nblocks,)
  const unsigned char* ovalid;  // (rows,)
  const int* ovox;              // (rows,)
  const float* of;              // (NF, rows)
  const int* ores;              // (1,)
  // scratch
  int* cap;            // (nblocks,) capacity for newcomers
  unsigned char* mis;  // (nblocks,) a kept lane outside the home brick
  int* count;          // (nkey,) valid rows of each key
  int* hist;           // (nkey, ntiles) counts, then first positions
  int* rank;           // (rows,) a valid row's rank in its tile and key
  int* first;          // (nkey + 1,) the first layout block of each key
  int* diff;           // (nkey,) c_k - capsum_k
  int* total;          // (1,) routed rows
  // outputs
  int* starts;            // (nblocks,)
  int* a;                 // (nblocks,)
  float* cf;              // (NF, ncompact)
  int* cvox;              // (ncompact,)
  unsigned char* cvalid;  // (ncompact,)
  long long* stats;       // (2,) routed rows, largest shortfall
  unsigned char* overflow;
  unsigned char* misplaced;
  unsigned char* rebuild;
  long long* causes;       // (3,) rebuckets by cause, device memory
  long long* causes_host;  // (3,) their mapped host copy
};

// n / d for an unsigned n and the invariant d of the magic m and shifts s1,
// s2 (Granlund and Montgomery, PLDI 1994, fig. 4.1; exact for every 32-bit
// n): a multiply-high and three shifts or adds where a division would take
// some twenty instructions
__device__ __forceinline__ unsigned div_by(unsigned n, unsigned m, int s1,
                                           int s2) {
  const unsigned t = __umulhi(m, n);
  return (t + ((n - t) >> s1)) >> s2;
}

// fused_push3d.brick_of(max(i, 1)), unclamped: i >= 1 splits into
// non-negative coordinates, and a brick side is a power of two, so the
// floor divisions of x - 1 >= -1 are arithmetic shifts
__device__ __forceinline__ int brick_of(const PlanArgs& p, int i) {
  i = max(i, 1);
  const int zi = (int)div_by((unsigned)i, p.mz, p.s1z, p.s2z);
  const int r = i - zi * p.sz;
  const int yi = (int)div_by((unsigned)r, p.my, p.s1y, p.s2y);
  const int xi = r - yi * p.sy;
  return ((xi - 1) >> p.lbx) +
         p.nbx * (((yi - 1) >> p.lby) + p.nby * ((zi - 1) >> p.lbz));
}

// the species of layout block j
__device__ __forceinline__ int species_of(const PlanArgs& p, int j) {
  int s = 0;
  while (s + 1 < p.nsp && j >= p.sp[s + 1].j0) ++s;
  return s;
}

__device__ __forceinline__ int block_key(const PlanArgs& p, int j) {
  const PlanSpecies& S = p.sp[species_of(p, j)];
  return S.spid * p.nb + S.home[j - S.j0];
}

// outbox row r's key, or -1 for an invalid row
__device__ __forceinline__ int row_key(const PlanArgs& p, int r) {
  if (!p.ovalid[r]) return -1;
  const PlanSpecies& S = p.sp[species_of(p, r / p.out_cap)];
  const int b = min(max(brick_of(p, p.ovox[r]), 0), p.nb - 1);
  return S.spid * p.nb + b;
}

__global__ void __launch_bounds__(LANE_THREADS)
    res_plan_lanes_kernel(const __grid_constant__ PlanArgs p) {
  const int j = blockIdx.x;
  const int t = threadIdx.x;
  for (int k = j * LANE_THREADS + t; k < p.nkey;
       k += gridDim.x * LANE_THREADS)
    p.count[k] = 0;

  const PlanSpecies& S = p.sp[species_of(p, j)];
  const int lb = j - S.j0;
  const int k0 = lb * BLOCK + t * LPT;
  // the marks of LPT lanes, 4 a word (bools are 0 or 1: byte l of word w is
  // lane k0 + 4w + l), and their voxels
  unsigned lv[LPT / 4], em[LPT / 4];
  int v[LPT];
  if ((lb + 1) * BLOCK <= S.n) {
    const uint4 l4 = *reinterpret_cast<const uint4*>(S.live + k0);
    const uint4 e4 = *reinterpret_cast<const uint4*>(S.emit + k0);
    lv[0] = l4.x, lv[1] = l4.y, lv[2] = l4.z, lv[3] = l4.w;
    em[0] = e4.x, em[1] = e4.y, em[2] = e4.z, em[3] = e4.w;
#pragma unroll
    for (int w = 0; w < LPT / 4; ++w) {
      const int4 q = *reinterpret_cast<const int4*>(S.vox + k0 + 4 * w);
      v[4 * w] = q.x, v[4 * w + 1] = q.y, v[4 * w + 2] = q.z,
      v[4 * w + 3] = q.w;
    }
  } else {  // a species' partial tail block
#pragma unroll
    for (int w = 0; w < LPT / 4; ++w) lv[w] = em[w] = 0u;
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const bool in = k0 + l < S.n;
      lv[l / 4] |= in ? (unsigned)S.live[k0 + l] << (8 * (l % 4)) : 0u;
      em[l / 4] |= in ? (unsigned)S.emit[k0 + l] << (8 * (l % 4)) : 0u;
      v[l] = in ? S.vox[k0 + l] : 0;
    }
  }
  const int home = S.home[lb];
  // the keys whose blocks start here: those after the previous block's key
  // up to this block's, and after the last block's, none (nblocks)
  const int kj = S.spid * p.nb + home;
  const int k0p = j > 0 ? block_key(p, j - 1) + 1 : 0;
  for (int k = k0p + t; k <= kj; k += LANE_THREADS) p.first[k] = j;
  if (j == p.nblocks - 1)
    for (int k = kj + 1 + t; k <= p.nkey; k += LANE_THREADS)
      p.first[k] = p.nblocks;

  int held = 0;
  bool bad = false;
#pragma unroll
  for (int w = 0; w < LPT / 4; ++w) {
    const unsigned l1 = lv[w] & 0x01010101u;
    const unsigned e1 = em[w] & 0x01010101u;
    const unsigned kept = l1 & ~e1;
    held += __popc(l1) - __popc(e1);
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if ((kept >> (8 * l)) & 1u) bad |= brick_of(p, v[4 * w + l]) != home;
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) held += __shfl_down_sync(FULL, held, o);
  __shared__ int wsum[LANE_THREADS / 32];
  if ((t & 31) == 0) wsum[t >> 5] = held;
  const int any_bad = __syncthreads_or(bad);
  if (t == 0) {
    int h = 0;
#pragma unroll
    for (int w = 0; w < LANE_THREADS / 32; ++w) h += wsum[w];
    const int free_slots = BLOCK - h;
    p.cap[j] = p.usable[j] ? min(max(free_slots, 0), p.inb) : 0;
    p.mis[j] = any_bad ? 1 : 0;
  }
}

__global__ void __launch_bounds__(TILE_THREADS)
    res_plan_tiles_kernel(const __grid_constant__ PlanArgs p) {
  extern __shared__ int cnt[];  // (nkey,) the tile's rows of each key so far
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int tile = blockIdx.x;
  for (int k = t; k < p.nkey; k += TILE_THREADS) cnt[k] = 0;
  __syncthreads();
  const int r0 = tile * p.g * p.out_cap;
  const int r1 = min(r0 + p.g * p.out_cap, p.rows);
  for (int c0 = r0; c0 < r1; c0 += AHEAD * TILE_THREADS) {
    // the keys of AHEAD chunks, their loads all in flight together
    int keys[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int r = c0 + u * TILE_THREADS + t;
      keys[u] = r < r1 ? row_key(p, r) : -1;
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int c = c0 + u * TILE_THREADS;
      if (c >= r1) break;  // the same for every thread
      const int r = c + t;
      const int key = keys[u];
      const unsigned peers = __match_any_sync(FULL, key);
      const int before = __popc(peers & ((1u << lane) - 1u));
      // warps in turn, so the ranks follow the row order
#pragma unroll
      for (int w = 0; w < TILE_THREADS / 32; ++w) {
        if (warp == w) {
          const int base = key >= 0 ? cnt[key] : 0;
          __syncwarp();
          if (key >= 0) {
            p.rank[r] = base + before;
            if (before == 0) cnt[key] = base + __popc(peers);
          }
        }
        __syncthreads();
      }
    }
  }
  for (int k = t; k < p.nkey; k += TILE_THREADS) {
    const int n = cnt[k];
    p.hist[(size_t)k * p.ntiles + tile] = n;
    if (n) atomicAdd(p.count + k, n);
  }
}

__global__ void __launch_bounds__(KEY_THREADS)
    res_plan_keys_kernel(const __grid_constant__ PlanArgs p) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  int below = 0;
  for (int q = t; q < k; q += KEY_THREADS) below += p.count[q];
  int seg;
  vpic_scan::block_excl_sum<KEY_THREADS>(below, &seg);
  const int ck = p.count[k];
  if (k == p.nkey - 1 && t == 0) *p.total = seg + ck;

  // each tile's first position of this key; a thread scans a run of tiles
  int* h = p.hist + (size_t)k * p.ntiles;
  const int per = (p.ntiles + KEY_THREADS - 1) / KEY_THREADS;
  const int t0 = min(t * per, p.ntiles);
  const int t1 = min(t0 + per, p.ntiles);
  int mine = 0;
  for (int q = t0; q < t1; ++q) mine += h[q];
  __syncthreads();
  int all;
  int pos = seg + vpic_scan::block_excl_sum<KEY_THREADS>(mine, &all);
  for (int q = t0; q < t1; ++q) {
    const int n = h[q];
    h[q] = pos;
    pos += n;
  }

  // the layout blocks of this key: their share of the key's rows
  const int j_lo = p.first[k];
  const int j_hi = p.first[k + 1];
  int prefix = 0;  // capacity of the key's blocks before the chunk
  for (int c = j_lo; c < j_hi; c += KEY_THREADS) {
    const int j = c + t;
    const int cap = j < j_hi ? p.cap[j] : 0;
    __syncthreads();
    int chunk;
    const int q0 = prefix + vpic_scan::block_excl_sum<KEY_THREADS>(cap, &chunk);
    if (j < j_hi) {
      const int q = min(ck, q0);
      p.a[j] = max(min(cap, ck - q), 0);
      p.starts[j] = seg + q;
    }
    prefix += chunk;
  }
  if (t == 0) p.diff[k] = ck - prefix;
}

__global__ void __launch_bounds__(ROW_THREADS)
    res_plan_scatter_kernel(const __grid_constant__ PlanArgs p) {
  const int t = threadIdx.x;
  if (blockIdx.x == gridDim.x - 1) {  // the flags
    int mx = INT_MIN;
    for (int k = t; k < p.nkey; k += ROW_THREADS) mx = max(mx, p.diff[k]);
    int mis = 0;
    for (int j = t; j < p.nblocks; j += ROW_THREADS) mis |= p.mis[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = max(mx, __shfl_down_sync(FULL, mx, o));
    __shared__ int wmax[ROW_THREADS / 32];
    if ((t & 31) == 0) wmax[t >> 5] = mx;
    const int any_mis = __syncthreads_or(mis);
    if (t == 0) {
      for (int w = 1; w < ROW_THREADS / 32; ++w) mx = max(mx, wmax[w]);
      const int total = *p.total;
      const bool over = mx > 0 || total > p.maxin;
      p.stats[0] = total;
      p.stats[1] = mx;
      const bool capped = *p.ores > 0;
      *p.overflow = over;
      *p.misplaced = any_mis != 0;
      *p.rebuild = over || capped || any_mis != 0;
      if (over || capped || any_mis != 0) {
        const int c = capped ? 0 : over ? 1 : 2;
        p.causes_host[c] = ++p.causes[c];
      }
    }
    return;
  }
  const int r = blockIdx.x * ROW_THREADS + t;
  if (r < p.ncompact) p.cvalid[r] = r < *p.total;
  if (r >= p.rows) return;
  const int key = row_key(p, r);
  if (key < 0) return;
  const int tile = r / p.out_cap / p.g;
  const int pos = p.hist[(size_t)key * p.ntiles + tile] + p.rank[r];
  if (pos >= p.ncompact) return;
#pragma unroll
  for (int f = 0; f < NF; ++f)
    p.cf[(size_t)f * p.ncompact + pos] = p.of[(size_t)f * p.rows + r];
  p.cvox[pos] = p.ovox[r];
}

}  // namespace

// sptrs: 4 pointers a species (live, emit, vox, home); sints: 4 ints a
// species (lanes, layout blocks, first layout block, key species index);
// dims: sy sz my s1y s2y mz s1z s2z lbx lby lbz nbx nby nb nkey nblocks
// out_cap g ntiles rows inb maxin ncompact (my, mz as 32-bit patterns);
// bufs: usable ovalid ovox of ores cap mis count hist rank first diff total
// starts a cf cvox cvalid stats overflow misplaced rebuild causes
// causes_host (the last the device pointer of res_plan_host_counts' memory).
// Every voxel array is 16-byte aligned, every mark array 4-byte aligned.
extern "C" int res_plan(int nsp, void* const* sptrs, const int* sints,
                        const int* dims, void* const* bufs, void* stream) {
  if (nsp < 1 || nsp > MAX_SPECIES) return (int)cudaErrorInvalidValue;
  PlanArgs p;
  for (int s = 0; s < nsp; ++s) {
    PlanSpecies& S = p.sp[s];
    S.live = (const unsigned char*)sptrs[4 * s];
    S.emit = (const unsigned char*)sptrs[4 * s + 1];
    S.vox = (const int*)sptrs[4 * s + 2];
    S.home = (const int*)sptrs[4 * s + 3];
    S.n = sints[4 * s];
    S.nblk = sints[4 * s + 1];
    S.j0 = sints[4 * s + 2];
    S.spid = sints[4 * s + 3];
  }
  p.nsp = nsp;
  int d = 0;
  p.sy = dims[d++];
  p.sz = dims[d++];
  p.my = (unsigned)dims[d++];
  p.s1y = dims[d++];
  p.s2y = dims[d++];
  p.mz = (unsigned)dims[d++];
  p.s1z = dims[d++];
  p.s2z = dims[d++];
  p.lbx = dims[d++];
  p.lby = dims[d++];
  p.lbz = dims[d++];
  p.nbx = dims[d++];
  p.nby = dims[d++];
  p.nb = dims[d++];
  p.nkey = dims[d++];
  p.nblocks = dims[d++];
  p.out_cap = dims[d++];
  p.g = dims[d++];
  p.ntiles = dims[d++];
  p.rows = dims[d++];
  p.inb = dims[d++];
  p.maxin = dims[d++];
  p.ncompact = dims[d++];
  int b = 0;
  p.usable = (const unsigned char*)bufs[b++];
  p.ovalid = (const unsigned char*)bufs[b++];
  p.ovox = (const int*)bufs[b++];
  p.of = (const float*)bufs[b++];
  p.ores = (const int*)bufs[b++];
  p.cap = (int*)bufs[b++];
  p.mis = (unsigned char*)bufs[b++];
  p.count = (int*)bufs[b++];
  p.hist = (int*)bufs[b++];
  p.rank = (int*)bufs[b++];
  p.first = (int*)bufs[b++];
  p.diff = (int*)bufs[b++];
  p.total = (int*)bufs[b++];
  p.starts = (int*)bufs[b++];
  p.a = (int*)bufs[b++];
  p.cf = (float*)bufs[b++];
  p.cvox = (int*)bufs[b++];
  p.cvalid = (unsigned char*)bufs[b++];
  p.stats = (long long*)bufs[b++];
  p.overflow = (unsigned char*)bufs[b++];
  p.misplaced = (unsigned char*)bufs[b++];
  p.rebuild = (unsigned char*)bufs[b++];
  p.causes = (long long*)bufs[b++];
  p.causes_host = (long long*)bufs[b++];
  if (p.nblocks < 1 || p.nkey < 1 || p.ntiles < 1 || p.rows < 1)
    return (int)cudaErrorInvalidValue;

  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)p.nkey * sizeof(int);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(res_plan_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  res_plan_lanes_kernel<<<p.nblocks, LANE_THREADS, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  res_plan_tiles_kernel<<<p.ntiles, TILE_THREADS, smem, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  res_plan_keys_kernel<<<p.nkey, KEY_THREADS, 0, st>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  res_plan_scatter_kernel<<<(p.rows + ROW_THREADS - 1) / ROW_THREADS + 1,
                            ROW_THREADS, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// n zeroed counts in mapped, page-locked host memory: *host is the host's
// pointer to them, *device the kernels'.  Never freed (one a device and
// process).
extern "C" int res_plan_host_counts(int n, void** host, void** device) {
  cudaError_t e = cudaHostAlloc(host, (size_t)n * sizeof(long long),
                                cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return (int)e;
  memset(*host, 0, (size_t)n * sizeof(long long));
  return (int)cudaHostGetDevicePointer(device, *host, 0);
}

extern "C" const char* res_plan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
