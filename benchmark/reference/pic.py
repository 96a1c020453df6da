"""The plain reference of one particle-in-cell step, in plain PyTorch.

A frozen copy of VPIC's step (advance.cc) as the port's plain versions
compute it, cut to what the benchmark's decks use: one domain, one vacuum
material filling all space, periodic or pec field faces, periodic or
reflecting particle faces.  It imports nothing of the program: the
benchmark holds the program against it, so it must not move when the
program changes.

Layouts are VPIC's: field arrays ``[z, y, x]`` with one ghost layer
(``(nz+2, ny+2, nx+2)``), voxel ``i = x + (nx+2) (y + (ny+2) z)``, lane
offsets in ``[-1, 1]`` about the voxel centre, momenta ``u = gamma beta``.
A state is plain data: ``fields`` a dict of the 16 arrays below, a species
a dict of the live lanes' ``dx dy dz i ux uy uz w`` with its ``q`` and
``m``.  Every function works in the dtype of its inputs (float32 for the
reference, bfloat16 for the control that stands in for a lower-precision
program).

Sources of each stage (VPIC file:line, as the port's docstrings cite
them): the interpolator (interpolator_array_pipeline.cc:21-126), the push
(advance_p_pipeline.cc:93-207, move_p.cc:216-353), the accumulator unload
(unload_accumulator_pipeline.cc:17-137), the field advance
(advance_b_pipeline.h, advance_e_pipeline.cc:60-210), the cleaners
(compute_div_e_err, clean_div_e, compute_div_b_err, clean_div_b), the
shared-face synchronization (remote.c:298-619) and the local face rules
(local.c).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

FIELD_NAMES = ("ex", "ey", "ez", "cbx", "cby", "cbz", "tcax", "tcay", "tcaz",
               "jfx", "jfy", "jfz", "rhof", "rhob", "div_e_err", "div_b_err")
LANE_NAMES = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w")

# field face codes
PERIODIC = 0
PEC = -1
# particle face codes
P_PERIODIC = 0
REFLECT = -1

ONE_THIRD = 1.0 / 3.0
TWO_FIFTEENTHS = 2.0 / 15.0
BIG = 3.4e38

ALL = slice(None)
INT = slice(1, -1)      # 1..n
INTH = slice(1, None)   # 1..n+1
LOH = slice(0, -1)      # 0..n
HI = slice(2, None)     # 2..n+1

_CB = ("cbx", "cby", "cbz")
_E = ("ex", "ey", "ez")
_TCA = ("tcax", "tcay", "tcaz")
_JF = ("jfx", "jfy", "jfz")


@dataclass(frozen=True)
class Geom:
    """One domain: interior cells, spacings, time step, units, the six
    faces' field and particle codes (order -x -y -z +x +y +z), the field
    damping and the cleaners' cadence."""

    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    dz: float
    dt: float
    cvac: float
    eps0: float
    field_bc: Tuple[int, ...]
    particle_bc: Tuple[int, ...]
    damp: float
    clean_interval: int
    max_streak: int = 4
    div_rounds: int = 2

    @property
    def NX(self):
        return self.nx + 2

    @property
    def NY(self):
        return self.ny + 2

    @property
    def NZ(self):
        return self.nz + 2

    @property
    def shape(self):
        return (self.NZ, self.NY, self.NX)

    @property
    def nv(self):
        return self.NX * self.NY * self.NZ

    @property
    def n(self):
        return (self.nx, self.ny, self.nz)

    @property
    def rd(self):
        return (1.0 / self.dx, 1.0 / self.dy, 1.0 / self.dz)

    @property
    def r8V(self):
        return 0.125 / (self.dx * self.dy * self.dz)

    def active(self, axis: int) -> bool:
        """An axis of more than one cell (a one-cell axis has no curl or
        divergence term)."""
        return self.n[axis] > 1


def zero_fields(g: Geom, dtype, device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(g.shape, dtype=dtype, device=device)
            for k in FIELD_NAMES}


# ---------------------------------------------------------------------------
# planes and face rules
# ---------------------------------------------------------------------------

def _plane(axis: int, idx):
    sl = [ALL, ALL, ALL]
    sl[2 - axis] = idx
    return tuple(sl)


def _axes_of(axis: int):
    return ((axis + 1) % 3, (axis + 2) % 3)


def _check_face(bc: int):
    if bc not in (PERIODIC, PEC):
        raise ValueError(f"the reference serves periodic and pec field "
                         f"faces only, not {bc}")


def _ghost(a, g: Geom, axis: int, side: int, mirror_idx: int):
    """Fill the ghost plane of ``axis`` on ``side``: a wrap on a periodic
    axis, else (pec) the plane ``mirror_idx`` itself."""
    n = g.n[axis]
    bc = g.field_bc[axis + (0 if side < 0 else 3)]
    _check_face(bc)
    src = (n if side < 0 else 1) if bc == PERIODIC else mirror_idx
    a[_plane(axis, 0 if side < 0 else n + 1)] = a[_plane(axis, src)].clone()


def ghost_tang_b(f, g: Geom):
    for axis in range(3):
        n = g.n[axis]
        for side in (-1, 1):
            for t in _axes_of(axis):
                _ghost(f[_CB[t]], g, axis, side, 1 if side < 0 else n)


def ghost_norm_e(f, g: Geom):
    for axis in range(3):
        n = g.n[axis]
        for names in (_E, _TCA):
            for side in (-1, 1):
                _ghost(f[names[axis]], g, axis, side, 1 if side < 0 else n)


def ghost_div_b(f, g: Geom):
    for axis in range(3):
        n = g.n[axis]
        for side in (-1, 1):
            _ghost(f["div_b_err"], g, axis, side, 1 if side < 0 else n)


def _pec_faces(g: Geom):
    for axis in range(3):
        for side in (-1, 1):
            bc = g.field_bc[axis + (0 if side < 0 else 3)]
            _check_face(bc)
            if bc == PEC:
                yield axis, (1 if side < 0 else g.n[axis] + 1)


def adjust_tang_e(f, g: Geom):
    for axis, idx in _pec_faces(g):
        for t in _axes_of(axis):
            f[_E[t]][_plane(axis, idx)] = 0.0
            f[_TCA[t]][_plane(axis, idx)] = 0.0


def adjust_div_e_err(f, g: Geom):
    for axis, idx in _pec_faces(g):
        f["div_e_err"][_plane(axis, idx)] = 0.0


def adjust_jf(f, g: Geom):
    for axis, idx in _pec_faces(g):
        for t in _axes_of(axis):
            f[_JF[t]][_plane(axis, idx)] = 0.0


def adjust_rho(f, g: Geom):
    for axis, idx in _pec_faces(g):
        f["rhof"][_plane(axis, idx)] = 0.0
        f["rhob"][_plane(axis, idx)] = 0.0


def _periodic_axes(g: Geom):
    return [a for a in range(3) if g.field_bc[a] == PERIODIC
            and g.field_bc[a + 3] == PERIODIC]


def _share(a, axis: int, g: Geom, mode: str):
    n = g.n[axis]
    lo = a[_plane(axis, 1)]
    hi = a[_plane(axis, n + 1)]
    v = lo + hi if mode == "sum" else 0.5 * (lo + hi)
    a[_plane(axis, 1)] = v
    a[_plane(axis, n + 1)] = v


def synchronize_jf(f, g: Geom):
    adjust_jf(f, g)
    for axis in _periodic_axes(g):
        for t in _axes_of(axis):
            _share(f[_JF[t]], axis, g, "sum")


def synchronize_rho(f, g: Geom):
    adjust_rho(f, g)
    for axis in _periodic_axes(g):
        _share(f["rhof"], axis, g, "sum")
        _share(f["rhob"], axis, g, "avg")


def synchronize_tang_e_norm_b(f, g: Geom):
    adjust_tang_e(f, g)
    for axis in _periodic_axes(g):
        _share(f[_CB[axis]], axis, g, "avg")
        for t in _axes_of(axis):
            _share(f[_E[t]], axis, g, "avg")
            _share(f[_TCA[t]], axis, g, "avg")


# ---------------------------------------------------------------------------
# the field advance and the cleaners (vacuum: every material coefficient 1)
# ---------------------------------------------------------------------------

def _s3(z=ALL, y=ALL, x=ALL):
    return (z, y, x)


def _coef(g: Geom, scale: float):
    return tuple(scale * g.rd[a] if g.active(a) else 0.0 for a in range(3))


def advance_b(f, g: Geom, frac: float):
    px, py, pz = _coef(g, frac * g.cvac * g.dt)
    ex, ey, ez = f["ex"], f["ey"], f["ez"]
    f["cbx"][_s3(INT, INT, INTH)] -= (
        py * (ez[_s3(INT, HI, INTH)] - ez[_s3(INT, INT, INTH)])
        - pz * (ey[_s3(HI, INT, INTH)] - ey[_s3(INT, INT, INTH)]))
    f["cby"][_s3(INT, INTH, INT)] -= (
        pz * (ex[_s3(HI, INTH, INT)] - ex[_s3(INT, INTH, INT)])
        - px * (ez[_s3(INT, INTH, HI)] - ez[_s3(INT, INTH, INT)]))
    f["cbz"][_s3(INTH, INT, INT)] -= (
        px * (ey[_s3(INTH, INT, HI)] - ey[_s3(INTH, INT, INT)])
        - py * (ex[_s3(INTH, HI, INT)] - ex[_s3(INTH, INT, INT)]))


_EDGE = (_s3(INTH, INTH, INT), _s3(INTH, INT, INTH), _s3(INT, INTH, INTH))


def _curl_b(f, px, py, pz):
    cbx, cby, cbz = f["cbx"], f["cby"], f["cbz"]
    t, ym, zm = _s3(INTH, INTH, INT), _s3(INTH, LOH, INT), _s3(LOH, INTH, INT)
    cx = py * (cbz[t] - cbz[ym]) - pz * (cby[t] - cby[zm])
    t, zm, xm = _s3(INTH, INT, INTH), _s3(LOH, INT, INTH), _s3(INTH, INT, LOH)
    cy = pz * (cbx[t] - cbx[zm]) - px * (cbz[t] - cbz[xm])
    t, xm, ym = _s3(INT, INTH, INTH), _s3(INT, INTH, LOH), _s3(INT, LOH, INTH)
    cz = px * (cby[t] - cby[xm]) - py * (cbx[t] - cbx[ym])
    return cx, cy, cz


def advance_e(f, g: Geom):
    ghost_tang_b(f, g)
    px, py, pz = _coef(g, (1 + g.damp) * g.cvac * g.dt)
    cj = g.dt / g.eps0
    curls = _curl_b(f, px, py, pz)
    for ax in range(3):
        t = _EDGE[ax]
        tca, e, jf = f[_TCA[ax]], f[_E[ax]], f[_JF[ax]]
        new_tca = curls[ax] - g.damp * tca[t]
        new_e = e[t] + (new_tca - cj * jf[t])
        tca[t] = new_tca
        e[t] = new_e
    adjust_tang_e(f, g)


def compute_curl_b(f, g: Geom):
    px, py, pz = _coef(g, g.cvac * g.dt)
    ghost_tang_b(f, g)
    curls = _curl_b(f, px, py, pz)
    for ax in range(3):
        f[_TCA[ax]][_EDGE[ax]] = curls[ax]
    adjust_tang_e(f, g)


_NODE = _s3(INTH, INTH, INTH)
_NODE_M = (_s3(INTH, INTH, LOH), _s3(INTH, LOH, INTH), _s3(LOH, INTH, INTH))


def _div_e(f, px, py, pz):
    xm, ym, zm = _NODE_M
    t = _NODE
    return (px * (f["ex"][t] - f["ex"][xm]) + py * (f["ey"][t] - f["ey"][ym])
            + pz * (f["ez"][t] - f["ez"][zm]))


def compute_div_e_err(f, g: Geom):
    ghost_norm_e(f, g)
    px, py, pz = _coef(g, 1.0)
    f["div_e_err"][_NODE] = _div_e(f, px, py, pz) - (1.0 / g.eps0) * (
        f["rhof"][_NODE] + f["rhob"][_NODE])
    adjust_div_e_err(f, g)


def compute_rhob(f, g: Geom):
    ghost_norm_e(f, g)
    px, py, pz = _coef(g, g.eps0)
    f["rhob"][_NODE] = _div_e(f, px, py, pz) - f["rhof"][_NODE]
    for axis, idx in _pec_faces(g):
        f["rhob"][_plane(axis, idx)] = 0.0


def _alpha(g: Geom):
    rdx, rdy, rdz = _coef(g, 1.0)
    a = 0.3888889 / (rdx * rdx + rdy * rdy + rdz * rdz)
    return a * rdx, a * rdy, a * rdz


def clean_div_e(f, g: Geom):
    px, py, pz = _alpha(g)
    err = f["div_e_err"]
    t = _s3(INTH, INTH, INT)
    f["ex"][t] += px * (err[_s3(INTH, INTH, HI)] - err[t])
    t = _s3(INTH, INT, INTH)
    f["ey"][t] += py * (err[_s3(INTH, HI, INTH)] - err[t])
    t = _s3(INT, INTH, INTH)
    f["ez"][t] += pz * (err[_s3(HI, INTH, INTH)] - err[t])


def compute_div_b_err(f, g: Geom):
    px, py, pz = _coef(g, 1.0)
    t = _s3(INT, INT, INT)
    f["div_b_err"][t] = (px * (f["cbx"][_s3(INT, INT, HI)] - f["cbx"][t])
                         + py * (f["cby"][_s3(INT, HI, INT)] - f["cby"][t])
                         + pz * (f["cbz"][_s3(HI, INT, INT)] - f["cbz"][t]))


def clean_div_b(f, g: Geom):
    ghost_div_b(f, g)
    px, py, pz = _alpha(g)
    err = f["div_b_err"]
    t = _s3(INT, INT, INTH)
    f["cbx"][t] += px * (err[t] - err[_s3(INT, INT, LOH)])
    t = _s3(INT, INTH, INT)
    f["cby"][t] += py * (err[t] - err[_s3(INT, LOH, INT)])
    t = _s3(INTH, INT, INT)
    f["cbz"][t] += pz * (err[t] - err[_s3(LOH, INT, INT)])


# ---------------------------------------------------------------------------
# the particle side
# ---------------------------------------------------------------------------

def load_interpolator(f, g: Geom) -> torch.Tensor:
    """The (nv, 18) interpolation table: E bilinear across its two
    transverse axes, cB linear along its own (ghost rows zero)."""
    t = _s3(INT, INT, INT)

    def shifted(*axes):
        sl = [INT, INT, INT]
        for ax in axes:
            sl[2 - ax] = HI
        return tuple(sl)

    def quads(a, ax1, ax2):
        w0, w1 = a[t], a[shifted(ax1)]
        w2, w3 = a[shifted(ax2)], a[shifted(ax1, ax2)]
        return (0.25 * ((w3 + w0) + (w1 + w2)), 0.25 * ((w3 - w0) + (w1 - w2)),
                0.25 * ((w3 - w0) - (w1 - w2)), 0.25 * ((w3 + w0) - (w1 + w2)))

    def lin(a, ax):
        w0, w1 = a[t], a[shifted(ax)]
        return 0.5 * (w1 + w0), 0.5 * (w1 - w0)

    comps = (quads(f["ex"], 1, 2) + quads(f["ey"], 2, 0)
             + quads(f["ez"], 0, 1) + lin(f["cbx"], 0) + lin(f["cby"], 1)
             + lin(f["cbz"], 2))
    out = torch.zeros((g.NZ, g.NY, g.NX, 18), dtype=f["ex"].dtype,
                      device=f["ex"].device)
    out[INT, INT, INT, :] = torch.stack(comps, dim=-1)
    return out.reshape(g.nv, 18)


def unload_accumulator(f, acc, g: Geom):
    """The (nv, 12) quarter-face currents folded into the edge currents."""
    a = acc.reshape(g.NZ, g.NY, g.NX, 12)
    rdx, rdy, rdz = g.rd
    cs = (0.25 * rdy * rdz / g.dt, 0.25 * rdz * rdx / g.dt,
          0.25 * rdx * rdy / g.dt)
    t = _s3(INTH, INTH, INTH)

    def fold(col0, c, ax1, ax2):
        s1, s2, s3 = list(t), list(t), list(t)
        s1[2 - ax1] = LOH
        s2[2 - ax2] = LOH
        s3[2 - ax1] = LOH
        s3[2 - ax2] = LOH
        return c * (a[t + (col0,)] + a[tuple(s1) + (col0 + 1,)]
                    + a[tuple(s2) + (col0 + 2,)] + a[tuple(s3) + (col0 + 3,)])

    f["jfx"][t] += fold(0, cs[0], 1, 2)
    f["jfy"][t] += fold(4, cs[1], 2, 0)
    f["jfz"][t] += fold(8, cs[2], 0, 1)


def decode(i: torch.Tensor, g: Geom):
    """(x, y, z) integer coordinates of voxel indices."""
    sz = g.NX * g.NY
    z = torch.div(i, sz, rounding_mode="floor")
    r = i - z * sz
    y = torch.div(r, g.NX, rounding_mode="floor")
    return r - y * g.NX, y, z


def _interp(rows, dx, dy, dz, qdt_2mc):
    hax = qdt_2mc * ((rows[:, 0] + dy * rows[:, 1])
                     + dz * (rows[:, 2] + dy * rows[:, 3]))
    hay = qdt_2mc * ((rows[:, 4] + dz * rows[:, 5])
                     + dx * (rows[:, 6] + dz * rows[:, 7]))
    haz = qdt_2mc * ((rows[:, 8] + dx * rows[:, 9])
                     + dy * (rows[:, 10] + dx * rows[:, 11]))
    return (hax, hay, haz, rows[:, 12] + dx * rows[:, 13],
            rows[:, 14] + dy * rows[:, 15], rows[:, 16] + dz * rows[:, 17])


def _boris(ux, uy, uz, cbx, cby, cbz, qdt):
    v0 = qdt * torch.rsqrt(1.0 + (ux * ux + (uy * uy + uz * uz)))
    v1 = cbx * cbx + (cby * cby + cbz * cbz)
    v2 = (v0 * v0) * v1
    v3 = v0 * (1.0 + v2 * (ONE_THIRD + v2 * TWO_FIFTEENTHS))
    v4 = v3 / (1.0 + v1 * (v3 * v3))
    v4 = v4 + v4
    w0 = ux + v3 * (uy * cbz - uz * cby)
    w1 = uy + v3 * (uz * cbx - ux * cbz)
    w2 = uz + v3 * (ux * cby - uy * cbx)
    return (ux + v4 * (w1 * cbz - w2 * cby), uy + v4 * (w2 * cbx - w0 * cbz),
            uz + v4 * (w0 * cby - w1 * cbx))


def _current(q, sdx, sdy, sdz, mx, my, mz):
    v5 = q * sdx * sdy * sdz * ONE_THIRD

    def one(qu, dY, dZ):
        v1 = qu * dY
        v0 = qu - v1
        v1 = v1 + qu
        a, b = 1.0 + dZ, 1.0 - dZ
        return (v0 * b + v5, v1 * b - v5, v0 * a - v5, v1 * a + v5)

    return torch.stack(one(q * sdx, my, mz) + one(q * sdy, mz, mx)
                       + one(q * sdz, mx, my), dim=-1)


def push(sp, fcoef, acc, g: Geom, steps: int = None):
    """One leapfrog step of a species' live lanes: interpolate, Boris
    push, walk the streak through the faces it crosses depositing the
    current of each piece into ``acc`` (in place).  Returns the lanes'
    new dict (voxel, offsets, momenta; weight unchanged)."""
    q, m = sp["q"], sp["m"]
    qdt_2mc = (q * g.dt) / (2.0 * m * g.cvac)
    dx, dy, dz = sp["dx"], sp["dy"], sp["dz"]
    rows = fcoef[sp["i"].long()]
    hax, hay, haz, cbx, cby, cbz = _interp(rows, dx, dy, dz, qdt_2mc)
    ux, uy, uz = _boris(sp["ux"] + hax, sp["uy"] + hay, sp["uz"] + haz,
                        cbx, cby, cbz, qdt_2mc)
    u = [ux + hax, uy + hay, uz + haz]
    rg = torch.rsqrt(1.0 + (u[0] * u[0] + (u[1] * u[1] + u[2] * u[2])))
    rd = g.rd
    disp = [u[a] * (g.cvac * g.dt * rd[a]) * rg for a in range(3)]
    pos = [dx, dy, dz]
    c = list(decode(sp["i"], g))
    qw = q * sp["w"]
    active = torch.ones_like(dx, dtype=torch.bool)
    big = min(BIG, torch.finfo(dx.dtype).max)
    for _ in range(g.max_streak if steps is None else steps):
        dirs = [torch.where(d > 0, 1.0, -1.0).to(dx.dtype) for d in disp]
        v = [torch.where(disp[a] == 0, big,
                         (dirs[a] - pos[a]) / torch.where(disp[a] == 0, 1.0,
                                                          disp[a]))
             for a in range(3)]
        v3 = torch.full_like(dx, 2.0)
        axis = torch.full_like(c[0], 3)
        for k in range(3):
            take = v[k] < v3
            v3 = torch.where(take, v[k], v3)
            axis = torch.where(take, k, axis)
        frac = 0.5 * v3
        s = [disp[a] * frac for a in range(3)]
        mid = [pos[a] + s[a] for a in range(3)]
        vox = c[0] + g.NX * (c[1] + g.NY * c[2])
        acc.index_add_(0, vox.long(), _current(
            qw * active.to(dx.dtype), s[0], s[1], s[2], mid[0], mid[1],
            mid[2]))
        for a in range(3):
            disp[a] = torch.where(active, disp[a] - s[a], disp[a])
            pos[a] = torch.where(active, pos[a] + s[a] + s[a], pos[a])
        crossing = active & (axis != 3)
        active = crossing
        for a in range(3):
            pos[a] = torch.where(crossing & (axis == a), dirs[a], pos[a])
        for a in range(3):
            mask = crossing & (axis == a)
            n = g.n[a]
            new = c[a] + (dirs[a] > 0).to(c[a].dtype) * 2 - 1
            lo, hi = mask & (new < 1), mask & (new > n)
            inside = mask & ~lo & ~hi
            coord = torch.where(inside, new, c[a])
            flip = inside
            for side, out in ((-1, lo), (1, hi)):
                bc = g.particle_bc[a + (0 if side < 0 else 3)]
                if bc == P_PERIODIC:
                    coord = torch.where(out, n if side < 0 else 1, coord)
                    flip = flip | out
                elif bc == REFLECT:
                    u[a] = torch.where(out, -u[a], u[a])
                    disp[a] = torch.where(out, -disp[a], disp[a])
                else:
                    raise ValueError(f"the reference serves periodic and "
                                     f"reflecting particle faces, not {bc}")
            c[a] = coord
            pos[a] = torch.where(flip, -pos[a], pos[a])
    vox = (c[0] + g.NX * (c[1] + g.NY * c[2])).to(sp["i"].dtype)
    return dict(sp, dx=pos[0], dy=pos[1], dz=pos[2], i=vox, ux=u[0],
                uy=u[1], uz=u[2])


def uncenter(sp, fcoef, g: Geom):
    """u from t to t - dt/2: a backward half rotation, then a backward
    half kick (uncenter_p_pipeline.cc:16-98)."""
    qdt_2mc = -(sp["q"] * g.dt) / (2.0 * sp["m"] * g.cvac)
    rows = fcoef[sp["i"].long()]
    hax, hay, haz, cbx, cby, cbz = _interp(rows, sp["dx"], sp["dy"],
                                           sp["dz"], qdt_2mc)
    ux, uy, uz = _boris(sp["ux"], sp["uy"], sp["uz"], cbx, cby, cbz,
                        0.5 * qdt_2mc)
    return dict(sp, ux=ux + hax, uy=uy + hay, uz=uz + haz)


def accumulate_rho(rhof, sp, g: Geom):
    """The lanes' charge on the nodes, trilinear, added to ``rhof``."""
    q = sp["q"] * g.r8V * sp["w"]
    dx, dy, dz = sp["dx"], sp["dy"], sp["dz"]
    mom = torch.zeros((g.nv, 8), dtype=rhof.dtype, device=rhof.device)
    mom.index_add_(0, sp["i"].long(), torch.stack(
        [q, q * dx, q * dy, q * dz, q * (dx * dy), q * (dx * dz),
         q * (dy * dz), q * (dx * (dy * dz))], dim=1))
    mom = mom.reshape(g.NZ, g.NY, g.NX, 8)
    rho = rhof.view(g.NZ, g.NY, g.NX)
    for c in (0, 1):
        for b in (0, 1):
            for a in (0, 1):
                sx, sy, sz = 2 * a - 1, 2 * b - 1, 2 * c - 1
                v = (mom[..., 0] + sx * mom[..., 1] + sy * mom[..., 2]
                     + sz * mom[..., 3] + (sx * sy) * mom[..., 4]
                     + (sx * sz) * mom[..., 5] + (sy * sz) * mom[..., 6]
                     + (sx * sy * sz) * mom[..., 7])
                rho[c:, b:, a:] += v[:g.NZ - c, :g.NY - b, :g.NX - a]


def clean_e(f, species: List[dict], g: Geom):
    f["rhof"].zero_()
    for sp in species:
        accumulate_rho(f["rhof"], sp, g)
    synchronize_rho(f, g)
    for _ in range(g.div_rounds):
        compute_div_e_err(f, g)
        clean_div_e(f, g)


def clean_b(f, g: Geom):
    for _ in range(g.div_rounds):
        compute_div_b_err(f, g)
        clean_div_b(f, g)


def step(fields: Dict[str, torch.Tensor], species: List[dict], g: Geom,
         k: int):
    """Step ``k`` -> ``k + 1`` from the given state (not changed): the
    interpolator, the push of every species into one accumulator, its
    unload into jf, the field advance (B half, E, B half), then on every
    ``clean_interval``-th step the div E and div B cleaners and the
    shared-face synchronization.  Returns (fields, species)."""
    f = {n: t.clone() for n, t in fields.items()}
    fcoef = load_interpolator(f, g)
    acc = torch.zeros((g.nv, 12), dtype=f["ex"].dtype, device=f["ex"].device)
    out = [push(sp, fcoef, acc, g) for sp in species]
    for n in _JF:
        f[n].zero_()
    unload_accumulator(f, acc, g)
    synchronize_jf(f, g)
    advance_b(f, g, 0.5)
    advance_e(f, g)
    advance_b(f, g, 0.5)
    if g.clean_interval > 0 and k % g.clean_interval == 0:
        clean_e(f, out, g)
        clean_b(f, g)
        synchronize_tang_e_norm_b(f, g)
    return f, out


def initialize(fields: Dict[str, torch.Tensor], species: List[dict],
               g: Geom):
    """initialize.cc:5-64 on a loaded state (no absorbed charge, no aged
    lanes): B cleaned, curl B, rho, rhob from div E, E cleaned, then u
    back half a step.  Returns (fields, species) on new tensors."""
    f = {n: t.clone() for n, t in fields.items()}
    synchronize_tang_e_norm_b(f, g)
    compute_div_b_err(f, g)
    clean_div_b(f, g)
    compute_curl_b(f, g)
    f["rhof"].zero_()
    for sp in species:
        accumulate_rho(f["rhof"], sp, g)
    synchronize_rho(f, g)
    compute_rhob(f, g)
    compute_div_e_err(f, g)
    clean_div_e(f, g)
    synchronize_tang_e_norm_b(f, g)
    fcoef = load_interpolator(f, g)
    return f, [uncenter(sp, fcoef, g) for sp in species]


def in_dtype(fields, species, dtype):
    """The state with every float array in ``dtype`` (voxels stay int)."""
    f = {n: t.to(dtype) for n, t in fields.items()}
    sps = [{k: (v.to(dtype) if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v) for k, v in sp.items()}
           for sp in species]
    return f, sps
