// push_lane.cuh -- the per-lane particle push shared by fused_push2d.cu and
// fused_push3d.cu, so the two kernels cannot drift apart, with the species
// table, the deposit tiles and the launch counters they share.
//
// push_lane() computes, for one live lane, what vpic_tpu/ops/push.py
// advance_p computes on one device:
//   1. read the lane's 18 interpolator coefficients straight from the
//      (nv, 18) load_interpolator table;
//   2. half E kick, relativistic Boris rotation (the reference's tan(theta/2)
//      expansion), half E kick -- push.py:192-222;
//   3. streak walk of at most max_streak rounds with the reference's
//      tie-break (x, y, z, strict <; end-of-track 2.0 wins ties) and BIG-guarded
//      divisions -- push.py:394-415; each round deposits the 12 quarter-face
//      currents of _accumulate_j_cols (push.py:224-245) into the CUDA block's
//      deposit tile in shared memory when the round's voxel lies in the tile,
//      else with atomicAdd into the (nv, 12) float32 accumulator in device
//      memory (the global path, counted);
//   4. periodic faces wrap to the canonical cell and reflecting faces bounce in
//      place, as push.py:528-543 does.  No particle ever sits in a ghost cell;
//   5. with WALLS (a compile-time switch: a launch on a deck without wall
//      faces runs the instance without this code), every face crossing first
//      reads the per-voxel-face code of its exit face from the (nv, 6) vbc
//      table when there is one (push.py:455-496: reflect, absorb, or park
//      with a ready-made pend code), then the domain face's rule: an
//      absorbing face ends the lane's walk on the face and kills it, and its
//      charge goes to rhob (accumulate_rhob, push.py:274-296, with float
//      atomics); a custom face ends the walk on the face with pend =
//      CUSTOM_BASE + face and the remaining displacement, for boundary_p;
//      on a decomposed grid a face that a neighbouring rank owns (P_REMOTE
//      in the rank's table p.bc) ends it on the face with pend = face and
//      the remaining displacement, for the migration rounds (push.py:
//      505-553: interior shard faces park with the bare face index).
//      The TPU kernels could not stop one lane of a block mid-walk, so they
//      froze every lane that might reach such a face (a p + 2 dp pre-flag
//      with a margin, and a dilated per-cell mark smuggled into the
//      interpolator table, pallas_push.py:439-474) and replayed those lanes
//      through the general path (:972-1048).  Here one thread walks one lane
//      and reads the face's rule where the walk meets it, which is what the
//      general path does; corner crossings need no dilation.
// The walk is dimension-general: z-crossings and periodic_z are handled like
// x and y, so the 2-D kernel (nz == 1) and the 3-D kernel share it unchanged.
// Steps 3-5 are walk_lane(), which move_p.cu also runs for the lanes a
// boundary handler re-emits with a new remaining displacement.
//
// What bounds the deposits, and what the tiles do about it.  The TPU kernels
// kept each block's accumulator in VMEM scratch and wrote it back once
// (pallas_push.py:301, 683; pallas_push3d.py:419, 832).  Here the tile is
// that scratch: a CUDA block zeroes TILE_STRIDE floats per voxel of its tile
// in shared memory, its lanes add their rounds there, and after a
// __syncthreads the block adds each non-zero tile entry into the accumulator
// with one device atomic.  Sorted lanes put a block's rounds on a few
// hundred voxels, so the device atomics fall from 12 per round per lane --
// which serialised in L2 on the addresses that every block of a brick or
// bucket shares -- to one per touched tile entry per block.  Hopper has no
// float add in shared memory: each of a round's 12 shared adds is a
// compare-and-swap loop (ATOMS.CAST.SPIN), and those loops are now the
// largest part of the deposits.  The pad word of TILE_STRIDE puts the
// voxels of a warp's lanes on different banks (with 12 floats, word j of
// every voxel fell on 8 of the 32), which took a third off the 3-D push.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W by utils/push_timing.py
// (device time per push of both species at the harris decks' shapes):
// 3-D 1.63-1.67 ms with device atomics, 0.52-0.55 ms with the tiles; 2-D
// 0.155-0.163 ms and 0.043-0.044 ms.  PERF.md has the breakdown.
//
// Only the order of the accumulator's sums changes.  The offsets'
// arithmetic in the walk is rounded one operation at a time (__fmul_rn,
// __fadd_rn), so no fused multiply-add that the compiler might form around
// the deposit branch moves a lane: the lane state comes out bit for bit as
// without tiles.

#pragma once

#include <cuda_runtime.h>

namespace vpic_push {

constexpr float ONE_THIRD = (float)(1.0 / 3.0);
constexpr float TWO_FIFTEENTHS = (float)(2.0 / 15.0);
constexpr float BIG = 3.4e38f;
constexpr unsigned FULL = 0xffffffffu;

// Species one launch takes; the wrappers split more into several launches.
constexpr int MAX_SPECIES = 8;
// Per species, the pointers the entry points take, in this order.
constexpr int SPECIES_PTRS = 13;

// Particle BC codes (vpic_tpu_torch/grid.py) and pend codes (ops/push.py).
constexpr int P_PERIODIC = 0;
constexpr int P_REMOTE = 1;
constexpr int REFLECT_PARTICLES = -1;
constexpr int ABSORB_PARTICLES = -2;
constexpr int DONE = -1;
constexpr int UNFINISHED = 6;
constexpr int CUSTOM_BASE = 8;

// One species' lanes and constants in the launch's species table (passed by
// value as a __grid_constant__ kernel parameter: no copy to the device).
struct Species {
  float* dx;
  float* dy;
  float* dz;
  int* vox;
  float* ux;
  float* uy;
  float* uz;
  float* w;         // written only where WALLS kills a lane
  bool* live;       // (the same)
  const int* home;  // 3-D: (nblocks,) layout block -> home brick, or null
  bool* emit;       // 3-D residency: (n,) emit marks, else null
  int* pend;        // WALLS: (n,) pend codes out, else null
  float* pdisp;     // WALLS: (3, n) remaining displacement out, else null
  int n;            // lanes
  int blk0;         // this species' first CUDA block in the launch
  int obx_col0;     // 3-D residency: this species' first outbox column
  float qdt_2mc;
  float qsp;
  float qr8v;       // qsp * r8V: an absorbed lane's rhob charge per weight
};

// Fills the species table from an entry point's host arrays: ptrs holds
// SPECIES_PTRS pointers per species (dx dy dz vox ux uy uz w live home emit
// pend pdisp).
inline void fill_species(Species* sp, int nsp, void* const* ptrs,
                         const int* n, const int* blk0, const int* col0,
                         const float* qdt_2mc, const float* qsp,
                         const float* qr8v) {
  for (int s = 0; s < nsp; ++s) {
    void* const* q = ptrs + (size_t)s * SPECIES_PTRS;
    Species& S = sp[s];
    S.dx = (float*)q[0];
    S.dy = (float*)q[1];
    S.dz = (float*)q[2];
    S.vox = (int*)q[3];
    S.ux = (float*)q[4];
    S.uy = (float*)q[5];
    S.uz = (float*)q[6];
    S.w = (float*)q[7];
    S.live = (bool*)q[8];
    S.home = (const int*)q[9];
    S.emit = (bool*)q[10];
    S.pend = (int*)q[11];
    S.pdisp = (float*)q[12];
    S.n = n[s];
    S.blk0 = blk0[s];
    S.obx_col0 = col0 ? col0[s] : 0;
    S.qdt_2mc = qdt_2mc[s];
    S.qsp = qsp[s];
    S.qr8v = qr8v[s];
  }
}

// The species whose CUDA blocks include this one (blk0 ascending).
__device__ __forceinline__ int species_of_block(const Species* sp, int nsp) {
  int s = 0;
  while (s + 1 < nsp && (int)blockIdx.x >= sp[s + 1].blk0) ++s;
  return s;
}

// What every lane of a launch shares.
struct PushParams {
  const float* fcoef;  // (nv, 18)
  float* acc;          // (nv, 12)
  float cdt_dx, cdt_dy, cdt_dz;
  int nx, ny, nz;
  int periodic_x, periodic_y, periodic_z;
  int max_streak;
  // WALLS only: each domain face's particle BC code (faces -x -y -z +x +y
  // +z), the (nv, 6) per-voxel-face code table or null, the (nv,) rhob
  int bc[6];
  const int* vbc;
  float* rhob;
};

// One lane's offsets, momentum and voxel coordinates (in and out); with
// WALLS also its pend code, remaining displacement and whether it died at
// an absorbing face.
struct Lane {
  float px, py, pz;
  float ux, uy, uz;
  int xi, yi, zi;
  int pend;
  float dpx, dpy, dpz;
  bool dead;
};

// A thread's deposit rounds: those that took the global path, and all.
struct Rounds {
  int global;
  int all;
};

// Floats a voxel takes in a deposit tile: its 12 currents and one pad word.
// With an odd stride the voxels of a warp's lanes fall on different banks;
// with 12 a round's word j of every voxel fell on 8 of the 32.
constexpr int TILE_STRIDE = 13;

// Deposit tiles in shared memory at the 32-bit shared address `base`.
// slot() gives a voxel's place in the tile, or -1 where it lies outside (its
// rounds then take the global path).
//
// BoxTile: the voxels [x0, x0+e) x [y0, y0+e) x [z0, z0+e); e = 0 is no tile.
struct BoxTile {
  unsigned base;
  int x0, y0, z0, e;
  __device__ __forceinline__ int slot(int x, int y, int z, int) const {
    const unsigned lx = (unsigned)(x - x0);
    const unsigned ly = (unsigned)(y - y0);
    const unsigned lz = (unsigned)(z - z0);
    const unsigned ue = (unsigned)e;
    return (lx < ue && ly < ue && lz < ue) ? (int)((lz * ue + ly) * ue + lx)
                                           : -1;
  }
};

// SpanTile: the linear voxels [v0, v0+len); len = 0 is no tile.
struct SpanTile {
  unsigned base;
  int v0, len;
  __device__ __forceinline__ int slot(int, int, int, int v) const {
    const unsigned d = (unsigned)(v - v0);
    return d < (unsigned)len ? (int)d : -1;
  }
};

// Where a round's 12 currents go: a tile entry in shared memory (there is no
// float add in shared memory on Hopper: red.shared.add.f32 compiles to a
// compare-and-swap loop, ATOMS.CAST.SPIN), or the accumulator row in device
// memory (REDG.E.ADD.F32).
struct SharedAdd {
  unsigned a;
  __device__ __forceinline__ void operator()(int j, float x) const {
    asm volatile("red.shared.add.f32 [%0], %1;" ::"r"(a + 4u * j), "f"(x)
                 : "memory");
  }
};

struct GlobalAdd {
  float* a;
  __device__ __forceinline__ void operator()(int j, float x) const {
    atomicAdd(a + j, x);
  }
};

// Four quarter-face currents of one component (push.py:229-239) into
// columns j..j+3.
template <class Add>
__device__ __forceinline__ void quad(const Add& add, int j, float qu,
                                     float dY, float dZ, float v5) {
  float v1 = qu * dY;
  float v0 = qu - v1;
  v1 = v1 + qu;
  const float c = 1.0f + dZ;
  const float v2 = v0 * c;
  const float v3 = v1 * c;
  const float d = 1.0f - dZ;
  v0 = v0 * d;
  v1 = v1 * d;
  add(j + 0, v0 + v5);
  add(j + 1, v1 - v5);
  add(j + 2, v2 - v5);
  add(j + 3, v3 + v5);
}

// The 12 currents of one streak segment (_accumulate_j_cols).
template <class Add>
__device__ __forceinline__ void deposit(const Add& add, float q0, float sdx,
                                        float sdy, float sdz, float midx,
                                        float midy, float midz) {
  const float v5 = q0 * sdx * sdy * sdz * ONE_THIRD;
  quad(add, 0, q0 * sdx, midy, midz, v5);
  quad(add, 4, q0 * sdy, midz, midx, v5);
  quad(add, 8, q0 * sdz, midx, midy, v5);
}

// One face crossing along one axis: the particle is put on the face, then
// either moves into the neighbour cell, wraps (periodic) or bounces
// (reflecting).  Mirrors the per-axis logic of push.py:443-565.
__device__ __forceinline__ void cross(float& pos, float& disp, float& u,
                                      int& coord, float dir, int n,
                                      int periodic) {
  pos = dir;
  const int newc = coord + (dir > 0.0f ? 1 : -1);
  if (newc >= 1 && newc <= n) {
    coord = newc;
    pos = -pos;
  } else if (periodic) {
    coord = newc < 1 ? n : 1;
    pos = -pos;
  } else {
    u = -u;
    disp = -disp;
  }
}

// What a crossing did to the lane's walk (WALLS).
enum Crossed { WALK_ON = 0, ABSORBED = 1, PARKED = 2 };

// One face crossing with every rule of the rank's faces (push.py:443-601):
// the particle is put on the face; the exit face's per-voxel code (vbc,
// read at the voxel `cur` being left) comes first, then the domain: a move
// into the neighbour cell, a periodic wrap, a reflecting bounce, an
// absorbing face (ABSORBED: the lane stays on the face), a face another
// rank owns (PARKED, with pend = face, for migration) or a custom face
// (PARKED, with pend = CUSTOM_BASE + face).
__device__ __forceinline__ Crossed cross_walls(const PushParams& p, int axis,
                                               float& pos, float& disp,
                                               float& u, int& coord,
                                               float dir, int n, int cur,
                                               int& pend) {
  pos = dir;
  const int face = axis + (dir > 0.0f ? 3 : 0);
  if (p.vbc) {
    const int code = __ldg(p.vbc + (size_t)cur * 6 + face);
    if (code == REFLECT_PARTICLES) {
      u = -u;
      disp = -disp;
      return WALK_ON;
    }
    if (code == ABSORB_PARTICLES) return ABSORBED;
    if (code >= CUSTOM_BASE) {
      pend = code;
      return PARKED;
    }
  }
  const int newc = coord + (dir > 0.0f ? 1 : -1);
  if (newc >= 1 && newc <= n) {
    coord = newc;
    pos = -pos;
    return WALK_ON;
  }
  const int bc = p.bc[face];
  if (bc == P_PERIODIC) {
    coord = newc < 1 ? n : 1;
    pos = -pos;
    return WALK_ON;
  }
  if (bc == REFLECT_PARTICLES) {
    u = -u;
    disp = -disp;
    return WALK_ON;
  }
  if (bc == ABSORB_PARTICLES) return ABSORBED;
  pend = bc == P_REMOTE ? face : CUSTOM_BASE + face;
  return PARKED;
}

// accumulate_rhob (push.py:274-296, rho_p.cc:126-211) of one lane of charge
// q = qsp * r8V * w at offsets (px, py, pz) in voxel (x, y, z): the
// trilinear node weights in VPIC's order, doubled on domain-edge nodes,
// added with float atomics (nodes past the mesh are dropped).  Each weight
// is rounded op by op as in the plain version.
__device__ __forceinline__ void deposit_rhob(const PushParams& p, int x, int y,
                                             int z, float px, float py,
                                             float pz, float q) {
  const int NX = p.nx + 2;
  const int SZ = NX * (p.ny + 2);
  const int NV = SZ * (p.nz + 2);
  float w6 = __fsub_rn(q, __fmul_rn(px, q));
  float w7 = __fadd_rn(q, __fmul_rn(px, q));
  float w4 = __fsub_rn(w6, __fmul_rn(py, w6));
  float w5 = __fsub_rn(w7, __fmul_rn(py, w7));
  w6 = __fadd_rn(w6, __fmul_rn(py, w6));
  w7 = __fadd_rn(w7, __fmul_rn(py, w7));
  float wt[8];
  wt[0] = __fsub_rn(w4, __fmul_rn(pz, w4));
  wt[1] = __fsub_rn(w5, __fmul_rn(pz, w5));
  wt[2] = __fsub_rn(w6, __fmul_rn(pz, w6));
  wt[3] = __fsub_rn(w7, __fmul_rn(pz, w7));
  wt[4] = __fadd_rn(w4, __fmul_rn(pz, w4));
  wt[5] = __fadd_rn(w5, __fmul_rn(pz, w5));
  wt[6] = __fadd_rn(w6, __fmul_rn(pz, w6));
  wt[7] = __fadd_rn(w7, __fmul_rn(pz, w7));
  const int v = x + NX * (y + (p.ny + 2) * z);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int hx = j & 1, hy = (j >> 1) & 1, hz = j >> 2;
    float f = 1.0f;
    if ((z == 1 && !hz) || (z == p.nz && hz)) f *= 2.0f;
    if ((y == 1 && !hy) || (y == p.ny && hy)) f *= 2.0f;
    if ((x == 1 && !hx) || (x == p.nx && hx)) f *= 2.0f;
    const int node = v + hx + NX * hy + SZ * hz;
    if (node < NV) atomicAdd(p.rhob + node, wt[j] * f);
  }
}

// Walk one live lane's displacement (dpx, dpy, dpz), in voxel offsets, from
// L's offsets and momentum in voxel (xi, yi, zi), for at most max_streak
// rounds (push.py streak_walk), depositing the currents of charge q0 (qsp *
// w) into `tile` where it holds the round's voxel.  On exit L holds the new
// offsets, momentum and voxel coordinates, and with WALLS its pend code
// (L.pend on entry, UNFINISHED, or a custom code), remaining displacement
// and whether it died at an absorbing face (its rhob deposit of charge
// qr8v * w made).  Adds the lane's rounds to `r`.  Returns true when the
// lane is still walking after max_streak rounds.  push_lane() calls it
// after the Boris push; move_p.cu calls it to walk on the lanes a boundary
// handler re-emitted.
template <bool WALLS, class Tile>
__device__ __forceinline__ bool walk_lane(const PushParams& p,
                                          const Tile& tile, float q0,
                                          float qr8v, float w, float dpx,
                                          float dpy, float dpz, int xi,
                                          int yi, int zi, Lane& L,
                                          Rounds& r) {
  const int NX = p.nx + 2;
  const int NY = p.ny + 2;
  float px = L.px;
  float py = L.py;
  float pz = L.pz;
  float ux = L.ux;
  float uy = L.uy;
  float uz = L.uz;
  bool active = true;
  int pend = L.pend;
  bool dead = false;
  for (int round = 0; round < p.max_streak; ++round) {
    const float dirx = dpx > 0.0f ? 1.0f : -1.0f;
    const float diry = dpy > 0.0f ? 1.0f : -1.0f;
    const float dirz = dpz > 0.0f ? 1.0f : -1.0f;
    const float s0 = dpx == 0.0f ? BIG : (dirx - px) / dpx;
    const float s1 = dpy == 0.0f ? BIG : (diry - py) / dpy;
    const float s2 = dpz == 0.0f ? BIG : (dirz - pz) / dpz;
    float s = 2.0f;
    int axis = 3;
    if (s0 < s) { s = s0; axis = 0; }
    if (s1 < s) { s = s1; axis = 1; }
    if (s2 < s) { s = s2; axis = 2; }
    const float frac = 0.5f * s;

    // the segment and the new offsets, each operation rounded on its own
    // (no fused multiply-add): the lane state then does not depend on how
    // the compiler schedules the deposits around them
    const float sdx = __fmul_rn(dpx, frac);
    const float sdy = __fmul_rn(dpy, frac);
    const float sdz = __fmul_rn(dpz, frac);
    const float midx = __fadd_rn(px, sdx);
    const float midy = __fadd_rn(py, sdy);
    const float midz = __fadd_rn(pz, sdz);

    const int cur = xi + NX * (yi + NY * zi);
    const int sl = tile.slot(xi, yi, zi, cur);
    if (sl >= 0) {
      deposit(SharedAdd{tile.base + 4u * TILE_STRIDE * (unsigned)sl}, q0,
              sdx, sdy, sdz, midx, midy, midz);
    } else {
      deposit(GlobalAdd{p.acc + (size_t)cur * 12}, q0, sdx, sdy, sdz, midx,
              midy, midz);
      ++r.global;
    }
    ++r.all;

    dpx = __fsub_rn(dpx, sdx);
    dpy = __fsub_rn(dpy, sdy);
    dpz = __fsub_rn(dpz, sdz);
    px = __fadd_rn(midx, sdx);
    py = __fadd_rn(midy, sdy);
    pz = __fadd_rn(midz, sdz);

    if (axis == 3) {
      active = false;
      break;
    }
    if (WALLS) {
      Crossed how;
      if (axis == 0) {
        how = cross_walls(p, 0, px, dpx, ux, xi, dirx, p.nx, cur, pend);
      } else if (axis == 1) {
        how = cross_walls(p, 1, py, dpy, uy, yi, diry, p.ny, cur, pend);
      } else {
        how = cross_walls(p, 2, pz, dpz, uz, zi, dirz, p.nz, cur, pend);
      }
      if (how != WALK_ON) {
        dead = how == ABSORBED;
        active = false;
        break;
      }
    } else if (axis == 0) {
      cross(px, dpx, ux, xi, dirx, p.nx, p.periodic_x);
    } else if (axis == 1) {
      cross(py, dpy, uy, yi, diry, p.ny, p.periodic_y);
    } else {
      cross(pz, dpz, uz, zi, dirz, p.nz, p.periodic_z);
    }
  }

  L.px = px;
  L.py = py;
  L.pz = pz;
  L.ux = ux;
  L.uy = uy;
  L.uz = uz;
  L.xi = xi;
  L.yi = yi;
  L.zi = zi;
  if (WALLS) {
    L.pend = active ? UNFINISHED : pend;
    L.dpx = dpx;
    L.dpy = dpy;
    L.dpz = dpz;
    L.dead = dead;
    if (dead) deposit_rhob(p, xi, yi, zi, px, py, pz, __fmul_rn(qr8v, w));
  }
  return active;
}

// Push one live lane of weight w sitting in linear voxel v, with the
// species constants qdt_2mc, qsp and qr8v (qsp * r8V), depositing into
// `tile` where it holds the round's voxel.  On entry L holds the lane's
// offsets and momentum; on exit its new offsets, momentum and voxel
// coordinates, and with WALLS its pend code (DONE, UNFINISHED or a custom
// code), remaining displacement and whether it died at an absorbing face
// (its rhob deposit made).  Adds the lane's rounds to `r`.  Returns true
// when the lane is still walking after max_streak rounds (an unfinished
// streak).
template <bool WALLS, class Tile>
__device__ __forceinline__ bool push_lane(const PushParams& p,
                                          const Tile& tile, float qdt_2mc,
                                          float qsp, float qr8v, int v,
                                          float w, Lane& L, Rounds& r) {
  const int NX = p.nx + 2;
  const int NY = p.ny + 2;
  const int SZ = NX * NY;

  float px = L.px;
  float py = L.py;
  float pz = L.pz;

  const float* row = p.fcoef + (size_t)v * 18;
  float c[18];
#pragma unroll
  for (int j = 0; j < 18; ++j) c[j] = __ldg(row + j);

  const float qdt = qdt_2mc;
  const float hax = qdt * ((c[0] + py * c[1]) + pz * (c[2] + py * c[3]));
  const float hay = qdt * ((c[4] + pz * c[5]) + px * (c[6] + pz * c[7]));
  const float haz = qdt * ((c[8] + px * c[9]) + py * (c[10] + px * c[11]));
  const float cbx = c[12] + px * c[13];
  const float cby = c[14] + py * c[15];
  const float cbz = c[16] + pz * c[17];

  float ux = L.ux + hax;
  float uy = L.uy + hay;
  float uz = L.uz + haz;
  const float v0 = qdt * (1.0f / sqrtf(1.0f + (ux * ux + (uy * uy + uz * uz))));
  const float v1 = cbx * cbx + (cby * cby + cbz * cbz);
  const float v2 = (v0 * v0) * v1;
  const float v3 = v0 * (1.0f + v2 * (ONE_THIRD + v2 * TWO_FIFTEENTHS));
  float v4 = v3 / (1.0f + v1 * (v3 * v3));
  v4 = v4 + v4;
  const float t0 = ux + v3 * (uy * cbz - uz * cby);
  const float t1 = uy + v3 * (uz * cbx - ux * cbz);
  const float t2 = uz + v3 * (ux * cby - uy * cbx);
  ux = ux + v4 * (t1 * cbz - t2 * cby);
  uy = uy + v4 * (t2 * cbx - t0 * cbz);
  uz = uz + v4 * (t0 * cby - t1 * cbx);
  ux = ux + hax;
  uy = uy + hay;
  uz = uz + haz;

  const float rg = 1.0f / sqrtf(1.0f + (ux * ux + (uy * uy + uz * uz)));
  const float dpx = ux * p.cdt_dx * rg;
  const float dpy = uy * p.cdt_dy * rg;
  const float dpz = uz * p.cdt_dz * rg;

  const int zi = v / SZ;
  const int rem = v - zi * SZ;
  const int yi = rem / NX;
  const int xi = rem - yi * NX;

  L.ux = ux;
  L.uy = uy;
  L.uz = uz;
  L.pend = DONE;
  return walk_lane<WALLS>(p, tile, qsp * w, qr8v, w, dpx, dpy, dpz, xi, yi,
                          zi, L, r);
}

// The WALLS per-lane outputs of lane k of a species, live when the push
// began: its pend code and remaining displacement, and live = false, w = 0
// where it died at an absorbing face.  Slots dead on entry are not written:
// their pend codes and displacement are undefined, and every reader masks
// them with the live flags.
__device__ __forceinline__ void store_walls(const Species& S, int k,
                                            const Lane& L) {
  S.pend[k] = L.pend;
  S.pdisp[k] = L.dpx;
  S.pdisp[(size_t)S.n + k] = L.dpy;
  S.pdisp[2 * (size_t)S.n + k] = L.dpz;
  if (L.dead) {
    S.live[k] = false;
    S.w[k] = 0.0f;
  }
}

// Adds every thread's rounds and unfinished lanes into the launch's counters
// (deposits[0] global-path rounds, deposits[1] all rounds), one device atomic
// of each per CUDA block.  `sh` is 3 shared words that thread 0 zeroed
// before any thread's last __syncthreads; every thread of the block must
// call it, converged.
__device__ __forceinline__ void add_counts(unsigned* sh, const Rounds& r,
                                           int unfinished_lanes,
                                           unsigned long long* deposits,
                                           int* unfinished) {
  const unsigned g = __reduce_add_sync(FULL, (unsigned)r.global);
  const unsigned a = __reduce_add_sync(FULL, (unsigned)r.all);
  const unsigned u = __reduce_add_sync(FULL, (unsigned)unfinished_lanes);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    if (g) atomicAdd(sh + 0, g);
    if (a) atomicAdd(sh + 1, a);
    if (u) atomicAdd(sh + 2, u);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (sh[0]) atomicAdd(deposits + 0, (unsigned long long)sh[0]);
    if (sh[1]) atomicAdd(deposits + 1, (unsigned long long)sh[1]);
    if (sh[2]) atomicAdd(unfinished, (int)sh[2]);
  }
}

}  // namespace vpic_push
