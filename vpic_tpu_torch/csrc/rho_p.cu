// rho_p.cu -- the cleaners' charge deposit (accumulate_rho_p), written by
// hand for Hopper (sm_90a).
//
// Replaces no TPU kernel: vpic_tpu/ops/push.py::accumulate_rho_p deposits
// the charge of every species in plain jnp, as a cell-moment form (one
// (N, 8) row of q * (1, dx, dy, dz, dxdy, dxdz, dydz, dxdydz) a lane added
// into an (nv, 8) table, then the node values from eight shifted dense
// combinations), and so does the plain PyTorch twin of this file,
// vpic_tpu_torch/ops/push.py::accumulate_rho_p (ops/rho_p.py runs it on CPU
// tensors).  On the card that form was ~138 launches a species: ~14
// elementwise passes, a torch.stack of the (N, 8) rows (~100 MB written and
// read back a species at 32^3 x 128 ppc), an index_add_ whose voxel-sorted
// rows pile onto one address after another, and 8 x 15 small grid-sized
// launches; ~6.5 ms a cleaning firing on the 32^3 x 128 ppc harris deck.
//
// One launch deposits every species (up to MAX_SPECIES; the species table
// is a __grid_constant__ parameter, and the species' CUDA blocks are dealt
// round-robin, species_of_block) straight into rhof's nodes.  Each live
// lane with q = qsp * r8V * w adds q (1 +- dx)(1 +- dy)(1 +- dz) to the 8
// nodes v + {0, 1} + sy {0, 1} + sz {0, 1} of its voxel v: the moment
// form's sum, in another order.  A node past the mesh on an axis
// (x + 1 == NX, ...) is dropped, as the shifted adds drop it; a 2-D grid
// still writes its z + 1 plane.  Dead slots add nothing.  float32
// throughout; each weight is rounded one product at a time,
// ((q * hx) * hy) * hz.
//
// Each CUDA block of THREADS threads serves a run of `run` consecutive
// 1024-lane layout blocks of one species, PER lanes a thread, loaded before
// any of them is used.  Two instances, chosen by whether home maps are given
// (the 3-D path's block -> home-brick maps, fused_push3d.py):
//   TILE: a layout block with a home brick deposits into a shared-memory
//     tile of the brick's 9^3 nodes; when a run's next block has another
//     home (or at the end of the run) the block adds each non-zero tile
//     entry into rhof with one device atomic.  A lane whose nodes leave the
//     tile (a lane outside its block's brick) and the lanes of blocks past
//     the home map take the global path below, so the result is right on any
//     layout; they are counted.  The residency layout keeps every live lane
//     in its block's brick at cleaning time, so none should;
//   no tile (the general 3-D path, the 2-D path): the global path alone.
//     A warp's lanes are grouped by voxel (__match_any_sync); each group's
//     leader adds the group's 8 sums with 8 device atomics.  Voxel-sorted
//     lanes share voxels, so the atomics on an address fall with the lanes
//     a voxel a warp.  On lanes in no order (a fresh load) a node takes
//     thousands of float adds of both signs, and the sum rounds far from
//     the exact one (~17 times the moment form's error on the 32^3 x 128
//     ppc harris load): initialize() and the diagnostics keep the plain
//     version for that reason.
// deposits[0] counts the lanes that took the global path, deposits[1] every
// live lane deposited.  The kernel allocates nothing and reads nothing on
// the host: a step captured in a CUDA graph holds it.
//
// What bounds it on the H100: bytes.  A slot's live mark (1 B), and a live
// lane's dx, dy, dz, voxel and weight (20 B): ~132 MB for the ~6.3M slots of
// the 32^3 x 128 ppc deck's two species, 0.04 ms at 3.35 TB/s; rhof is
// 0.14 MB and stays in L2.  What the design does about contention: the
// device atomics of the old index_add_ (one row a lane onto the voxel's
// address, serialised in L2) become shared-memory adds into a tile that only
// the block's own lanes touch, and one device atomic a touched node a tile
// (~729 a run of a brick's blocks).  Hopper adds floats in shared memory
// with a compare-and-swap loop (push_lane.cuh says so of the push's tiles);
// the interleaved residency layout spreads a warp's lanes over the brick's
// 512 voxels, so few of a warp's adds meet on one address.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 without
// --use_fast_math.  The entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SPECIES = 8;
// Per species, the pointers the entry point takes, in this order.
constexpr int SPECIES_PTRS = 7;
constexpr int LANES = 1024;           // lanes of a layout block
constexpr int THREADS = 256;          // threads of a CUDA block
constexpr int PER = LANES / THREADS;  // lanes a thread a layout block
constexpr int B3 = 8;                 // brick side (cells)
constexpr int TN = B3 + 1;            // tile side (nodes)
constexpr int TILE_NODES = TN * TN * TN;
constexpr unsigned FULL = 0xffffffffu;

struct Species {
  const float* dx;
  const float* dy;
  const float* dz;
  const int* vox;
  const float* w;
  const bool* live;
  const int* home;  // (nhome,) layout block -> home brick, or null
  int n;            // slots
  int nhome;
  int blk0;         // first CUDA block of the species' tail
  float qr8v;       // qsp * r8V
};

struct RhoArgs {
  Species sp[MAX_SPECIES];
  int nsp;
  int head;  // CUDA blocks of every species dealt round-robin
  int run;  // layout blocks a CUDA block
  float* rho;  // (nv,)
  int NX, NY, NZ;  // the mesh with its ghost layers
  int nbx, nby, nb;  // bricks along x and y, and in all (TILE)
  unsigned long long* deposits;  // (2,)
};

// The species of this CUDA block and its index among the species' CUDA
// blocks.  The first nsp * head CUDA blocks are dealt round-robin, species
// after species, so blocks of every species start together and rhof's
// nodes take the adds of both signs (ions and electrons) mixed: its running
// sums stay near the net charge, and so does their rounding.  Each
// species' other CUDA blocks (its tail) follow from its blk0.
__device__ __forceinline__ int species_of_block(const RhoArgs& p,
                                                int* local) {
  const int b = blockIdx.x;
  if (b < p.nsp * p.head) {
    *local = b / p.nsp;
    return b % p.nsp;
  }
  int s = 0;
  while (s + 1 < p.nsp && b >= p.sp[s + 1].blk0) ++s;
  *local = p.head + b - p.sp[s].blk0;
  return s;
}

// The 8 node weights of a lane, node j = a + 2b + 4c at v + a + sy b + sz c.
__device__ __forceinline__ void node_weights(float q, float dx, float dy,
                                             float dz, float* wt) {
  const float hy0 = 1.0f - dy, hy1 = 1.0f + dy;
  const float hz0 = 1.0f - dz, hz1 = 1.0f + dz;
  const float qx0 = q * (1.0f - dx), qx1 = q * (1.0f + dx);
  const float a00 = qx0 * hy0, a10 = qx1 * hy0;
  const float a01 = qx0 * hy1, a11 = qx1 * hy1;
  wt[0] = a00 * hz0;
  wt[1] = a10 * hz0;
  wt[2] = a01 * hz0;
  wt[3] = a11 * hz0;
  wt[4] = a00 * hz1;
  wt[5] = a10 * hz1;
  wt[6] = a01 * hz1;
  wt[7] = a11 * hz1;
}

// The global path.  Every lane of the warp calls it together; `want` marks
// the lanes that deposit here.  Lanes of one voxel sum their weights (each
// walks its group's other members with one shuffle a weight, all groups at
// once) and the group's lowest lane adds the sums to the voxel's nodes.
__device__ __forceinline__ void deposit_global(bool want, int v, int x,
                                               int y, int z, const float* wt,
                                               const RhoArgs& p) {
  if (!__ballot_sync(FULL, want)) return;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(FULL, want ? v : -1);
  unsigned rest = want ? peers & ~(1u << lane) : 0u;
  float s[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j] = wt[j];
  while (__any_sync(FULL, rest != 0u)) {
    const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float o = __shfl_sync(FULL, wt[j], src);
      if (rest) s[j] += o;
    }
    rest &= rest - 1u;
  }
  if (!want || lane != __ffs(peers) - 1) return;
  const int sy = p.NX;
  const int sz = p.NX * p.NY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int a = j & 1, b = (j >> 1) & 1, c = j >> 2;
    if (x + a < p.NX && y + b < p.NY && z + c < p.NZ)
      atomicAdd(p.rho + v + a + sy * b + sz * c, s[j]);
  }
}

// Adds each non-zero tile entry into rhof; every thread calls it after a
// __syncthreads.  The tile's nodes lie inside the mesh.
__device__ __forceinline__ void flush_tile(const float* tile, int x0, int y0,
                                           int z0, const RhoArgs& p) {
  for (int e = threadIdx.x; e < TILE_NODES; e += THREADS) {
    const float a = tile[e];
    if (a == 0.0f) continue;
    const int lx = e % TN;
    const int ly = e / TN % TN;
    const int lz = e / (TN * TN);
    atomicAdd(p.rho + (x0 + lx) + p.NX * ((y0 + ly) + p.NY * (z0 + lz)), a);
  }
}

template <bool TILE>
__global__ void __launch_bounds__(THREADS)
    rho_p_kernel(const __grid_constant__ RhoArgs p) {
  __shared__ float tile[TILE ? TILE_NODES : 1];
  __shared__ unsigned counts[2];
  const int t = threadIdx.x;
  int local;
  const Species& S = p.sp[species_of_block(p, &local)];
  const int nblk = (S.n + LANES - 1) / LANES;
  const int b_begin = local * p.run;
  const int b_end = min(b_begin + p.run, nblk);
  const int sz = p.NX * p.NY;
  const int nv = sz * p.NZ;
  if (t == 0) counts[0] = counts[1] = 0;

  int cur = -1;  // the tile's home brick, -1: no tile
  int x0 = 0, y0 = 0, z0 = 0;  // the tile's first node
  unsigned glob = 0, all = 0;
  for (int b = b_begin; b < b_end; ++b) {
    if (TILE) {
      int home = S.home && b < S.nhome ? S.home[b] : -1;  // uniform
      if (home < 0 || home >= p.nb) home = -1;
      if (home != cur) {
        __syncthreads();
        if (cur >= 0) {
          flush_tile(tile, x0, y0, z0, p);
          __syncthreads();
        }
        if (home >= 0) {
          for (int e = t; e < TILE_NODES; e += THREADS) tile[e] = 0.0f;
          x0 = home % p.nbx * B3 + 1;
          y0 = home / p.nbx % p.nby * B3 + 1;
          z0 = home / (p.nbx * p.nby) * B3 + 1;
        }
        cur = home;
        __syncthreads();
      }
    }

    bool live[PER];
    float dx[PER], dy[PER], dz[PER], w[PER];
    int v[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int k = b * LANES + u * THREADS + t;
      live[u] = k < S.n && S.live[k];
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int k = b * LANES + u * THREADS + t;
      dx[u] = dy[u] = dz[u] = w[u] = 0.0f;
      v[u] = -1;
      if (live[u]) {
        dx[u] = S.dx[k];
        dy[u] = S.dy[k];
        dz[u] = S.dz[k];
        w[u] = S.w[k];
        v[u] = S.vox[k];
      }
    }
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const bool ok = live[u] && v[u] >= 0 && v[u] < nv;
      const int z = ok ? v[u] / sz : 0;
      const int r = v[u] - z * sz;
      const int y = ok ? r / p.NX : 0;
      const int x = r - y * p.NX;
      float wt[8];
      node_weights(S.qr8v * w[u], dx[u], dy[u], dz[u], wt);
      bool global = ok;
      if (TILE && ok && cur >= 0) {
        const unsigned lx = (unsigned)(x - x0);
        const unsigned ly = (unsigned)(y - y0);
        const unsigned lz = (unsigned)(z - z0);
        if (lx < B3 && ly < B3 && lz < B3) {
          global = false;
          const int e = lx + TN * (ly + TN * lz);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            atomicAdd(tile + e + (j & 1) + TN * ((j >> 1) & 1) +
                          TN * TN * (j >> 2),
                      wt[j]);
        }
      }
      glob += global;
      all += ok;
      deposit_global(global, v[u], x, y, z, wt, p);
    }
  }
  if (TILE && cur >= 0) {
    __syncthreads();
    flush_tile(tile, x0, y0, z0, p);
  }
  const unsigned g = __reduce_add_sync(FULL, glob);
  const unsigned a = __reduce_add_sync(FULL, all);
  __syncthreads();
  if ((t & 31) == 0) {
    if (g) atomicAdd(counts + 0, g);
    if (a) atomicAdd(counts + 1, a);
  }
  __syncthreads();
  if (t == 0) {
    if (counts[0]) atomicAdd(p.deposits + 0, (unsigned long long)counts[0]);
    if (counts[1]) atomicAdd(p.deposits + 1, (unsigned long long)counts[1]);
  }
}

}  // namespace

// ptrs: SPECIES_PTRS pointers per species (dx dy dz vox w live home; home
// null without a home map); n, nhome, blk0, qr8v: one per species (host
// arrays); grid: CUDA blocks, each serving `run` layout blocks, the first
// nsp * head of them dealt round-robin over the species.  tile != 0
// launches the TILE instance (every home map on a grid of 8^3 bricks).
extern "C" int rho_p(int nsp, void* const* ptrs, const int* n,
                     const int* nhome, const int* blk0, const float* qr8v,
                     int grid, int head, int run, float* rho, int nx,
                     int ny, int nz, int tile, unsigned long long* deposits,
                     void* stream) {
  if (grid <= 0) return 0;
  if (nsp < 1 || nsp > MAX_SPECIES || run < 1 || head < 0 ||
      (tile && (nx % B3 || ny % B3 || nz % B3)))
    return (int)cudaErrorInvalidValue;
  RhoArgs a;
  for (int s = 0; s < nsp; ++s) {
    void* const* q = ptrs + (size_t)s * SPECIES_PTRS;
    Species& S = a.sp[s];
    S.dx = (const float*)q[0];
    S.dy = (const float*)q[1];
    S.dz = (const float*)q[2];
    S.vox = (const int*)q[3];
    S.w = (const float*)q[4];
    S.live = (const bool*)q[5];
    S.home = (const int*)q[6];
    S.n = n[s];
    S.nhome = nhome[s];
    S.blk0 = blk0[s];
    S.qr8v = qr8v[s];
  }
  a.nsp = nsp;
  a.head = head;
  a.run = run;
  a.rho = rho;
  a.NX = nx + 2;
  a.NY = ny + 2;
  a.NZ = nz + 2;
  a.nbx = nx / B3;
  a.nby = ny / B3;
  a.nb = tile ? a.nbx * a.nby * (nz / B3) : 0;
  a.deposits = deposits;
  if (tile)
    rho_p_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  else
    rho_p_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// CUDA blocks of the kernel (the TILE instance if tile) one SM holds at once.
extern "C" int rho_p_blocks_per_sm(int tile) {
  int blocks = 0;
  if (tile)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, rho_p_kernel<true>,
                                                  THREADS, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks,
                                                  rho_p_kernel<false>,
                                                  THREADS, 0);
  return blocks;
}

extern "C" const char* rho_p_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
