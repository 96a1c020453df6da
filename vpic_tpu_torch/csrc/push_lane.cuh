// push_lane.cuh -- the per-lane particle push shared by fused_push2d.cu and
// fused_push3d.cu, so the two kernels cannot drift apart.
//
// push_lane() computes, for one live lane, what vpic_tpu/ops/push.py
// advance_p computes for periodic and reflecting particle faces:
//   1. read the lane's 18 interpolator coefficients straight from the
//      (nv, 18) load_interpolator table;
//   2. half E kick, relativistic Boris rotation (the reference's tan(theta/2)
//      expansion), half E kick -- push.py:192-222;
//   3. streak walk of at most max_streak rounds with the reference's
//      tie-break (x, y, z, strict <; end-of-track 2.0 wins ties) and BIG-guarded
//      divisions -- push.py:394-415; each round deposits the 12 quarter-face
//      currents of _accumulate_j_cols (push.py:224-245) with atomicAdd into
//      the (nv, 12) float32 accumulator;
//   4. periodic faces wrap to the canonical cell and reflecting faces bounce in
//      place, as push.py:528-543 does.  No particle ever sits in a ghost cell.
// The walk is dimension-general: z-crossings and periodic_z are handled like
// x and y, so the 2-D kernel (nz == 1) and the 3-D kernel share it unchanged.

#pragma once

#include <cuda_runtime.h>

namespace vpic_push {

constexpr float ONE_THIRD = (float)(1.0 / 3.0);
constexpr float TWO_FIFTEENTHS = (float)(2.0 / 15.0);
constexpr float BIG = 3.4e38f;

// What every lane of one species' launch shares.
struct PushParams {
  const float* fcoef;  // (nv, 18)
  float* acc;          // (nv, 12)
  float qdt_2mc;
  float qsp;
  float cdt_dx, cdt_dy, cdt_dz;
  int nx, ny, nz;
  int periodic_x, periodic_y, periodic_z;
  int max_streak;
};

// One lane's offsets, momentum and voxel coordinates (in and out).
struct Lane {
  float px, py, pz;
  float ux, uy, uz;
  int xi, yi, zi;
};

// Four quarter-face currents of one component (push.py:229-239).
__device__ __forceinline__ void quad(float* a, float qu, float dY, float dZ,
                                     float v5) {
  float v1 = qu * dY;
  float v0 = qu - v1;
  v1 = v1 + qu;
  const float c = 1.0f + dZ;
  const float v2 = v0 * c;
  const float v3 = v1 * c;
  const float d = 1.0f - dZ;
  v0 = v0 * d;
  v1 = v1 * d;
  atomicAdd(a + 0, v0 + v5);
  atomicAdd(a + 1, v1 - v5);
  atomicAdd(a + 2, v2 - v5);
  atomicAdd(a + 3, v3 + v5);
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

// Push one live lane of weight w sitting in linear voxel v.  On entry L holds
// the lane's offsets and momentum; on exit its new offsets, momentum and
// voxel coordinates.  Returns true when the lane is still walking after
// max_streak rounds (an unfinished streak).
__device__ __forceinline__ bool push_lane(const PushParams& p, int v, float w,
                                          Lane& L) {
  const int NX = p.nx + 2;
  const int NY = p.ny + 2;
  const int SZ = NX * NY;

  float px = L.px;
  float py = L.py;
  float pz = L.pz;

  const float* r = p.fcoef + (size_t)v * 18;
  float c[18];
#pragma unroll
  for (int j = 0; j < 18; ++j) c[j] = __ldg(r + j);

  const float qdt = p.qdt_2mc;
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
  float dpx = ux * p.cdt_dx * rg;
  float dpy = uy * p.cdt_dy * rg;
  float dpz = uz * p.cdt_dz * rg;

  int zi = v / SZ;
  const int rem = v - zi * SZ;
  int yi = rem / NX;
  int xi = rem - yi * NX;

  const float q0 = p.qsp * w;
  bool active = true;
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

    const float sdx = dpx * frac;
    const float sdy = dpy * frac;
    const float sdz = dpz * frac;
    const float midx = px + sdx;
    const float midy = py + sdy;
    const float midz = pz + sdz;

    float* a = p.acc + (size_t)(xi + NX * (yi + NY * zi)) * 12;
    const float v5 = q0 * sdx * sdy * sdz * ONE_THIRD;
    quad(a + 0, q0 * sdx, midy, midz, v5);
    quad(a + 4, q0 * sdy, midz, midx, v5);
    quad(a + 8, q0 * sdz, midx, midy, v5);

    dpx = dpx - sdx;
    dpy = dpy - sdy;
    dpz = dpz - sdz;
    px = px + sdx + sdx;
    py = py + sdy + sdy;
    pz = pz + sdz + sdz;

    if (axis == 3) {
      active = false;
      break;
    }
    if (axis == 0) {
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
  return active;
}

}  // namespace vpic_push
