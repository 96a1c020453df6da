// merge_p.cu -- the residency merge, written by hand for Hopper (sm_90a).
//
// Replaces: vpic_tpu/ops/residency.py::_merge_kernel (the Pallas TPU kernel
// that compacts each 1024-lane block's survivors with exact one-hot dots and
// appends the block's routed newcomers, every species in one launch).  Its
// plain PyTorch twin is vpic_tpu_torch/ops/residency.py::merge_p_ref.
//
// One launch merges every species (up to MAX_SPECIES; the species table is a
// __grid_constant__ parameter) into destination arrays that may be the input
// arrays themselves: the residency step merges IN PLACE into the state.  One
// CUDA block of 256 threads per 1024-lane block, four consecutive lanes a
// thread:
//   1. each thread loads its lanes' live and emit marks as one 32-bit word
//      each and the 8 lane words (dx dy dz vox ux uy uz w) with one 16-byte
//      load a field, so the whole lane block is in registers before any
//      store;
//   2. an exclusive prefix sum of the keepers (live and not emitted) over the
//      block (block_scan.cuh) gives each keeper its slot, in lane order;
//   3. a block with no keepers and no newcomers keeps its rows with live 0,
//      and w set to 0 where the lane was dead
//      (vpic_tpu/ops/residency.py:282, 296-298);
//      otherwise the keepers go to their slots in shared memory (8 x 1056
//      words, padded by a word per 32 against bank conflicts), a barrier,
//      and each thread builds its four slots: a keeper from shared memory,
//      one of the block's a_j newcomers from the destination-sorted compact
//      rows [starts_j, starts_j + a_j) that plan_exchange built, or zeros;
//   4. each thread stores its slots with 16-byte stores, and where the
//      destination is the input it stores only the 16 bytes that change.
//      Slots before the block's first dropped lane hold the same lane, and
//      dead slots stay zero from the previous merge, so in a steady run most
//      of their words are not written again.
// The result is bit-identical to residency.merge_p in every lane, dead lanes
// included.  Rows that merge_p moves through its one-hot dots lose the sign
// of a zero (x * 1 summed with +0 terms); the kernel adds +0.0f to each moved
// float to do the same.  Compact rows past the compact array read as zeros,
// as merge_p's zero-padded window does.  Each block adds its live lanes to
// its species' count (np, zeroed by the wrapper).
//
// Why the aliasing is safe: a CUDA block reads and writes only its own lane
// block (the compact rows, the marks and starts_j / a_j are other arrays),
// and within it each thread stores exactly the four slots whose lanes it
// loaded, after loading them; the keepers reach other threads' slots
// through shared memory, read after the barrier.  So no store can reach a
// word before its one read, whatever the order of blocks and warps.
//
// What bounds it on the H100: bytes.  Written to new arrays, every slot
// reads its marks and keepers' words and writes 9 output words: ~304 MB, at
// 3.35 TB/s 0.091 ms at the 32^3 x 128 ppc deck (chip_smoke.py).  In place,
// the least is the marks of every slot plus the reads and writes of the
// slots that change (87 % of them there) and the newcomers' reads: 0.086
// ms.  The kernel reads every slot's words once (to know which change), in
// 16-byte loads issued before the scan, and launches once for every
// species: 0.111 ms a merge of both species (the parent's two launches of
// one thread a lane took 0.192); storing every 16 bytes took 0.120.
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md.)
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 without
// --use_fast_math.  The entry point returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

using vpic_scan::BLOCK;

constexpr int THREADS = 256;
constexpr int LPT = BLOCK / THREADS;  // lanes a thread
constexpr int WORDS = 8;              // dx dy dz vox ux uy uz w
constexpr int VOX = 3;                // the one word that is not a float
constexpr int W = 7;
constexpr int PAD = BLOCK + BLOCK / 32;  // a shared row, one pad word per 32
constexpr int MAX_SPECIES = 8;
// Per species, the pointers the entry point takes, in this order: the 8
// input words, live, emit, the 8 output words, output live, np.
constexpr int SPECIES_PTRS = 2 * WORDS + 4;

struct MergeSpecies {
  const unsigned* in[WORDS];
  const unsigned char* live;
  const unsigned char* emit;
  unsigned* out[WORDS];
  unsigned char* olive;
  int* np;   // (1,): this species' live lanes after the merge, added to
  int blk0;  // this species' first CUDA block in the launch
  int j0;    // its first layout block in starts / a
};

struct MergeArgs {
  MergeSpecies sp[MAX_SPECIES];
  int nsp;
  const float* cf;    // (7, cstride): dx dy dz ux uy uz w
  const int* cvox;    // (cstride,)
  int cstride;
  int m;              // valid compact columns
  const int* starts;  // (layout blocks,) over every species
  const int* a;
};

__device__ __forceinline__ unsigned word_of(const uint4& v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}

__device__ __forceinline__ unsigned plus_zero(unsigned bits) {
  return __float_as_uint(__fadd_rn(__uint_as_float(bits), 0.0f));
}

// Stores v at dst unless dst is the input word and already holds v.
__device__ __forceinline__ void store_changed(unsigned* dst, const uint4& v,
                                              const uint4& old, bool same) {
  if (!same || v.x != old.x || v.y != old.y || v.z != old.z || v.w != old.w)
    *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ void store_changed(unsigned char* dst, unsigned v,
                                              unsigned old, bool same) {
  if (!same || v != old) *reinterpret_cast<unsigned*>(dst) = v;
}

__global__ void __launch_bounds__(THREADS)
    merge_kernel(const __grid_constant__ MergeArgs p) {
  __shared__ unsigned rows[WORDS][PAD];  // the block's keepers, by slot
  int s = 0;
  while (s + 1 < p.nsp && (int)blockIdx.x >= p.sp[s + 1].blk0) ++s;
  const MergeSpecies& S = p.sp[s];
  const int lb = (int)blockIdx.x - S.blk0;
  const int j = S.j0 + lb;
  const int t = threadIdx.x;
  const int s0 = t * LPT;  // this thread's first lane (and slot) in the block
  const size_t k = (size_t)lb * BLOCK + s0;

  // 1. the whole lane block, before any store
  const unsigned lv4 = *reinterpret_cast<const unsigned*>(S.live + k);
  const unsigned em4 = *reinterpret_cast<const unsigned*>(S.emit + k);
  uint4 x[WORDS];
#pragma unroll
  for (int f = 0; f < WORDS; ++f)
    x[f] = *reinterpret_cast<const uint4*>(S.in[f] + k);
  const int na = p.a[j];
  const int start = p.starts[j];

  // 2. keepers' slots (bools are 0 or 1: byte l of a word is lane s0 + l)
  const unsigned keep4 = lv4 & ~em4 & 0x01010101u;
  int nk;
  int pos = vpic_scan::block_excl_sum<THREADS>(__popc(keep4), &nk);
  const int ntot = nk + na;

  // 3-4. a block with no keepers and no newcomers (uniform over the block)
  if (ntot == 0) {
#pragma unroll
    for (int f = 0; f < WORDS; ++f) {
      uint4 v = x[f];
      if (f == W) {
        if (!(lv4 & 0x000000ffu)) v.x = 0u;
        if (!(lv4 & 0x0000ff00u)) v.y = 0u;
        if (!(lv4 & 0x00ff0000u)) v.z = 0u;
        if (!(lv4 & 0xff000000u)) v.w = 0u;
      }
      store_changed(S.out[f] + k, v, x[f], S.out[f] == S.in[f]);
    }
    store_changed(S.olive + k, 0u, lv4, S.olive == S.live);
    return;
  }

#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    if ((keep4 >> (8 * l)) & 1u) {
      const int q = pos + (pos >> 5);
#pragma unroll
      for (int f = 0; f < WORDS; ++f) rows[f][q] = word_of(x[f], l);
      ++pos;
    }
  }
  __syncthreads();

  // the compact column of each slot's newcomer, or -1
  long long col[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int slot = s0 + l;
    const long long c = (long long)start + (slot - nk);
    col[l] = slot >= nk && slot < ntot && c >= 0 && c < p.m ? c : -1;
  }
#pragma unroll
  for (int f = 0; f < WORDS; ++f) {
    unsigned v[LPT];
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int slot = s0 + l;
      unsigned b = 0u;
      if (slot < nk) {
        b = rows[f][slot + (slot >> 5)];
      } else if (col[l] >= 0) {
        const int r = f < VOX ? f : f - 1;  // the compact row of a float
        b = f == VOX ? (unsigned)p.cvox[col[l]]
                     : __float_as_uint(p.cf[(size_t)r * p.cstride + col[l]]);
      }
      v[l] = f == VOX ? b : plus_zero(b);
    }
    store_changed(S.out[f] + k, make_uint4(v[0], v[1], v[2], v[3]), x[f],
                  S.out[f] == S.in[f]);
  }
  unsigned live = 0u;
#pragma unroll
  for (int l = 0; l < LPT; ++l)
    if (s0 + l < ntot) live |= 1u << (8 * l);
  store_changed(S.olive + k, live, lv4, S.olive == S.live);
  if (t == 0) atomicAdd(S.np, max(0, min(ntot, BLOCK)));
}

}  // namespace

// ptrs: SPECIES_PTRS pointers per species (the 8 input words dx dy dz vox ux
// uy uz w, live, emit, the 8 output words, output live, np; an output may be
// its input); blk0, j0: one per species (host arrays): its first CUDA block
// and its first entry of starts / a; grid: CUDA blocks (layout blocks of
// every species).  Every lane array is 16-byte aligned, every mark array
// 4-byte aligned, and each species' lane count a multiple of 1024.
extern "C" int merge_p(int nsp, void* const* ptrs, const int* blk0,
                       const int* j0, int grid, const float* cf,
                       const int* cvox, int cstride, int m, const int* starts,
                       const int* a, void* stream) {
  if (grid <= 0) return 0;
  if (nsp < 1 || nsp > MAX_SPECIES) return (int)cudaErrorInvalidValue;
  MergeArgs g;
  for (int s = 0; s < nsp; ++s) {
    void* const* q = ptrs + (size_t)s * SPECIES_PTRS;
    MergeSpecies& S = g.sp[s];
    for (int f = 0; f < WORDS; ++f) {
      S.in[f] = (const unsigned*)q[f];
      S.out[f] = (unsigned*)q[WORDS + 2 + f];
    }
    S.live = (const unsigned char*)q[WORDS];
    S.emit = (const unsigned char*)q[WORDS + 1];
    S.olive = (unsigned char*)q[2 * WORDS + 2];
    S.np = (int*)q[2 * WORDS + 3];
    S.blk0 = blk0[s];
    S.j0 = j0[s];
  }
  g.nsp = nsp;
  g.cf = cf;
  g.cvox = cvox;
  g.cstride = cstride;
  g.m = m;
  g.starts = starts;
  g.a = a;
  merge_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

extern "C" const char* merge_p_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
