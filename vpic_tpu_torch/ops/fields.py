"""Yee-mesh FDTD field solver, divergence cleaners and face synchronization
(counterpart of ``vpic_tpu/ops/fields.py``).

* Stencils are whole-array slice arithmetic over ghosted ``[z, y, x]``
  tensors.
* Every op updates the FieldState's tensors IN PLACE and returns the same
  FieldState; statements run in the JAX package's order, so each one sees
  exactly the values its counterpart sees.
* Ghost fills and local BCs: PERIODIC faces wrap; pec, symmetric/pmc and
  absorbing faces apply their local rule.
* Decomposed grids (one process per rank, ``parallel/mesh.py``): a rank's
  faces are ``grid.rank_field_bc``.  A REMOTE face takes its partner's
  plane (``_shard_halo_plane``: the JAX package's ppermute, here a
  ``Mesh.ppermute`` over the ``grid.halo_partners`` tables), and the
  shared-face sums and averages combine a rank's boundary plane with its
  partner's; a face on the global domain's edge applies its own rule, as
  the JAX package's per-shard where() picks.  Every rank makes every
  exchange in the same order (the exchange is collective even where a
  rank keeps its own rule), and ``all_sum`` is ``Mesh.all_sum``.

Spatial axis convention: X=0, Y=1, Z=2; array axes are [z,y,x] so the
array axis of spatial axis a is ``2 - a``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..grid import (ABSORB_FIELDS, ANTI_SYMMETRIC, PERIODIC, PMC, REMOTE,
                    SYMMETRIC, Grid, flat_rank, halo_partners, rank_field_bc)
from ..state import FieldState, MaterialCoeffs

_ALL = slice(None)

# Slices named by spatial extent (FORTRAN index ranges on 0..n+1 arrays):
INT = slice(1, -1)      # 1..n
INTH = slice(1, None)   # 1..n+1
LO = slice(0, -2)       # 0..n-1   (x-1 of 1..n)
LOH = slice(0, -1)      # 0..n     (x-1 of 1..n+1)
HI = slice(2, None)     # 2..n+1   (x+1 of 1..n)

_CB = ("cbx", "cby", "cbz")
_E = ("ex", "ey", "ez")
_TCA = ("tcax", "tcay", "tcaz")
_JF = ("jfx", "jfy", "jfz")


def _arr_axis(spatial_axis: int) -> int:
    return 2 - spatial_axis


def _plane_idx(spatial_axis: int, idx):
    sl = [_ALL, _ALL, _ALL]
    sl[_arr_axis(spatial_axis)] = idx
    return tuple(sl)


def get_plane(a, spatial_axis: int, idx):
    """A view of plane ``idx`` along ``spatial_axis``."""
    return a[_plane_idx(spatial_axis, idx)]


def set_plane(a, spatial_axis: int, idx, val):
    """Write ``val`` into plane ``idx`` of ``a`` in place."""
    a[_plane_idx(spatial_axis, idx)] = val
    return a


def _sl3(zsl=_ALL, ysl=_ALL, xsl=_ALL):
    return (zsl, ysl, xsl)


def _slc(a, sl):
    """Slice a mesh-shaped coefficient; broadcast 0-d scalars untouched."""
    return a[sl] if a.dim() == 3 else a


def _axes_of(axis: int) -> Tuple[int, int]:
    """The two axes transverse to ``axis`` (cyclic: x->(y,z), y->(z,x), z->(x,y))."""
    return ((axis + 1) % 3, (axis + 2) % 3)


def _rank_bc(g: Grid):
    """This rank's six field face codes (the grid's own undecomposed)."""
    return rank_field_bc(g, flat_rank(g)) if g.sharded else g.field_bc


def _exchanges(g: Grid, face: int) -> bool:
    """True when some rank takes face ``face``'s ghost from a partner (the
    exchange is then made by every rank)."""
    return g.sharded and any(p >= 0 for p in halo_partners(g)[face])


def _pairs(g: Grid, face: int):
    """(source, destination) pairs of face ``face``: each rank receives
    from its partner on that face."""
    return [(p, r) for r, p in enumerate(halo_partners(g)[face]) if p >= 0]


def _shard_halo_plane(a, axis: int, side: int, g: Grid):
    """The partner's boundary plane for my ghost on (axis, side): every rank
    sends plane n toward +axis for the low ghosts, plane 1 toward -axis for
    the high ghosts (vpic_tpu/ops/fields.py:138-155)."""
    from ..parallel.mesh import mesh_of
    n = (g.nx, g.ny, g.nz)[axis]
    plane = get_plane(a, axis, n if side < 0 else 1)
    return mesh_of(g).ppermute(plane, _pairs(g, axis + (0 if side < 0
                                                        else 3)))


def _ghost_value(local_fn, a, axis, side, bc, g: Grid):
    """The ghost plane's new value: the partner's plane on a REMOTE face of
    this rank, a wrap on a PERIODIC one, else the face's local rule."""
    face = axis + (0 if side < 0 else 3)
    remote = _shard_halo_plane(a, axis, side, g) \
        if _exchanges(g, face) else None
    eff = _rank_bc(g)[face]
    if eff == REMOTE:
        if remote is None:
            raise ValueError(f"field face {face} is REMOTE on an "
                             "undecomposed grid")
        return remote
    if eff == PERIODIC:
        n = (g.nx, g.ny, g.nz)[axis]
        return get_plane(a, axis, n if side < 0 else 1)
    return local_fn()


def _plane_shift(arr, plane_axis: int, plane_idx: int, shift_axis: int,
                 shift: int):
    """Plane ``plane_idx`` along ``plane_axis`` of ``arr`` shifted by
    ``shift`` voxels along ``shift_axis`` (zero-filled at the array edge)."""
    plane = get_plane(arr, plane_axis, plane_idx)
    rem = [ax for ax in (0, 1, 2) if ax != _arr_axis(plane_axis)]
    pax = rem.index(_arr_axis(shift_axis))
    n = plane.shape[pax]
    out = torch.zeros_like(plane)
    src = [_ALL, _ALL]
    dst = [_ALL, _ALL]
    if shift > 0:
        src[pax] = slice(shift, n)
        dst[pax] = slice(0, n - shift)
    else:
        src[pax] = slice(0, n + shift)
        dst[pax] = slice(-shift, n)
    out[tuple(dst)] = plane[tuple(src)]
    return out


def ghost_tang_b(f: FieldState, g: Grid) -> FieldState:
    """local_ghost_tang_b (local.c:50-122): fill ghost tangential cB planes."""
    e = {name: getattr(f, name) for name in _E}
    for axis in range(3):
        n = (g.nx, g.ny, g.nz)[axis]
        cdt_dn = g.cvac * g.dt * (g.rdx, g.rdy, g.rdz)[axis]
        t_axes = _axes_of(axis)
        for side in (-1, 1):
            bc = g.axis_bc(axis, side)
            ghost = 0 if side < 0 else n + 1
            mirror = 1 if side < 0 else n
            for t in t_axes:
                a = getattr(f, _CB[t])

                def local_fn(a=a, t=t, axis=axis, side=side, bc=bc,
                             mirror=mirror, ghost=ghost, n=n, cdt_dn=cdt_dn,
                             t_axes=t_axes):
                    if bc == ANTI_SYMMETRIC:
                        return get_plane(a, axis, mirror)
                    if bc in (SYMMETRIC, PMC):
                        return -get_plane(a, axis, mirror)
                    if bc == ABSORB_FIELDS:
                        # Higdon/Mur hybrid ABC (local.c:82-107), as in
                        # vpic_tpu.ops.fields.ghost_tang_b.
                        higend = 1.03527618 if (g.gnx > 1 or g.gny > 1 or
                                                g.gnz > 1) else 1.0
                        drive = cdt_dn * higend
                        decay = (1.0 - drive) / (1.0 + drive)
                        drive = 2.0 * drive / (1.0 + drive)
                        o = t_axes[1] if t == t_axes[0] else t_axes[0]
                        e_o = e[_E[o]]
                        e_n = e[_E[axis]]
                        face = 1 if side < 0 else n + 1
                        t1 = cdt_dn * (
                            get_plane(e_o, axis, face + (1 if side < 0 else -1))
                            - get_plane(e_o, axis, face))
                        if side > 0:
                            t1 = -t1
                        cdt_do = g.cvac * g.dt * (g.rdx, g.rdy, g.rdz)[o]
                        t2 = cdt_do * (_plane_shift(e_n, axis, mirror, o, +1)
                                       - get_plane(e_n, axis, mirror))
                        base = (decay * get_plane(a, axis, ghost)
                                + drive * get_plane(a, axis, mirror))
                        return (base - t1 + t2 if t == t_axes[0]
                                else base + t1 - t2)
                    raise ValueError(f"bad field bc {bc}")

                val = _ghost_value(local_fn, a, axis, side, bc, g)
                set_plane(a, axis, ghost, val.clone())
    return f


def ghost_norm_e(f: FieldState, g: Grid) -> FieldState:
    """local_ghost_norm_e (local.c:128-179): ghost normal E (+ tca) planes."""
    for axis in range(3):
        n = (g.nx, g.ny, g.nz)[axis]
        for comp_set in (_E, _TCA):
            a = getattr(f, comp_set[axis])
            for side in (-1, 1):
                bc = g.axis_bc(axis, side)
                ghost = 0 if side < 0 else n + 1
                m1 = 1 if side < 0 else n
                m2 = 2 if side < 0 else n - 1

                def local_fn(a=a, bc=bc, axis=axis, m1=m1, m2=m2):
                    if bc == ANTI_SYMMETRIC:
                        return get_plane(a, axis, m1)
                    if bc in (SYMMETRIC, PMC):
                        return -get_plane(a, axis, m1)
                    if bc == ABSORB_FIELDS:
                        return (2.0 * get_plane(a, axis, m1)
                                - get_plane(a, axis, m2))
                    raise ValueError(f"bad field bc {bc}")

                val = _ghost_value(local_fn, a, axis, side, bc, g)
                set_plane(a, axis, ghost, val.clone())
    return f


def ghost_div_b(f: FieldState, g: Grid) -> FieldState:
    """local_ghost_div_b (local.c:181-215)."""
    a = f.div_b_err
    for axis in range(3):
        n = (g.nx, g.ny, g.nz)[axis]
        for side in (-1, 1):
            bc = g.axis_bc(axis, side)
            ghost = 0 if side < 0 else n + 1
            mirror = 1 if side < 0 else n

            def local_fn(bc=bc, axis=axis, mirror=mirror):
                if bc == ANTI_SYMMETRIC:
                    return get_plane(a, axis, mirror)
                if bc in (SYMMETRIC, PMC):
                    return -get_plane(a, axis, mirror)
                if bc == ABSORB_FIELDS:
                    return torch.zeros_like(get_plane(a, axis, mirror))
                raise ValueError(f"bad field bc {bc}")

            val = _ghost_value(local_fn, a, axis, side, bc, g)
            set_plane(a, axis, ghost, val.clone())
    return f


# ---------------------------------------------------------------------------
# Local adjusts (local.c:224-444)
# ---------------------------------------------------------------------------

def _local_faces(g: Grid):
    """Yield (axis, side, bc) for faces with a *local* (non-comm) BC."""
    for axis in range(3):
        for side in (-1, 1):
            bc = g.axis_bc(axis, side)
            if bc not in (PERIODIC, REMOTE):
                yield axis, side, bc


def _set_boundary_plane(a, axis, side, g: Grid, new_plane):
    """Set the boundary plane (index 1 or n+1) in place; on a decomposed
    grid only a rank whose face keeps its own rule does (the others' plane
    is shared with a partner)."""
    n = (g.nx, g.ny, g.nz)[axis]
    if g.sharded and _rank_bc(g)[axis + (0 if side < 0 else 3)] == REMOTE:
        return a
    return set_plane(a, axis, 1 if side < 0 else n + 1, new_plane)


def adjust_tang_e(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_tang_e: zero tangential E/TCA on pec boundary planes."""
    for axis, side, bc in _local_faces(g):
        if bc != ANTI_SYMMETRIC:
            continue
        for t in _axes_of(axis):
            for comp_set in (_E, _TCA):
                _set_boundary_plane(getattr(f, comp_set[t]), axis, side, g,
                                    0.0)
    return f


def adjust_norm_b(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_norm_b: zero normal cB on symmetric boundary planes."""
    for axis, side, bc in _local_faces(g):
        if bc == SYMMETRIC:
            _set_boundary_plane(getattr(f, _CB[axis]), axis, side, g, 0.0)
    return f


def adjust_div_e_err(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_div_e: zero div-E error on pec/absorbing boundary nodes."""
    for axis, side, bc in _local_faces(g):
        if bc in (ANTI_SYMMETRIC, ABSORB_FIELDS):
            _set_boundary_plane(f.div_e_err, axis, side, g, 0.0)
    return f


def adjust_jf(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_jf (local.c:335-368): zero (pec) or double (sym/pmc/abs)
    tangential jf on boundary planes."""
    for axis, side, bc in _local_faces(g):
        n = (g.nx, g.ny, g.nz)[axis]
        face = 1 if side < 0 else n + 1
        scale = 0.0 if bc == ANTI_SYMMETRIC else 2.0
        for t in _axes_of(axis):
            a = getattr(f, _JF[t])
            _set_boundary_plane(a, axis, side, g,
                                scale * get_plane(a, axis, face))
    return f


def adjust_rhof(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_rhof: zero (pec) or double (sym/pmc/abs) boundary rhof."""
    a = f.rhof
    for axis, side, bc in _local_faces(g):
        n = (g.nx, g.ny, g.nz)[axis]
        face = 1 if side < 0 else n + 1
        scale = 0.0 if bc == ANTI_SYMMETRIC else 2.0
        _set_boundary_plane(a, axis, side, g, scale * get_plane(a, axis, face))
    return f


def adjust_rhob(f: FieldState, g: Grid) -> FieldState:
    """local_adjust_rhob: zero boundary rhob on pec faces only."""
    for axis, side, bc in _local_faces(g):
        if bc == ANTI_SYMMETRIC:
            _set_boundary_plane(f.rhob, axis, side, g, 0.0)
    return f


# ---------------------------------------------------------------------------
# Shared-face synchronization (remote.c:298-619).  A locally PERIODIC axis
# combines plane 1 with plane n+1; on a decomposed axis each rank combines
# its boundary planes with its partners' (the combine is commutative, so
# both ranks of a face get bit-equal planes).
# ---------------------------------------------------------------------------

def _sync_axes(g: Grid):
    """Axes whose boundary planes are shared: (axis, across ranks?)."""
    for axis in range(3):
        if _exchanges(g, axis) or _exchanges(g, axis + 3):
            yield axis, True
        elif (g.axis_bc(axis, -1) == PERIODIC
              and g.axis_bc(axis, 1) == PERIODIC):
            yield axis, False


def _combine(lo, hi, mode):
    if mode == "sum":
        return lo + hi
    if mode == "avg":
        return 0.5 * (lo + hi)
    raise ValueError(mode)


def _combine_shared(a, axis: int, g: Grid, cross: bool, mode: str,
                    want_err: bool = False):
    n = (g.nx, g.ny, g.nz)[axis]
    lo = get_plane(a, axis, 1)
    hi = get_plane(a, axis, n + 1)
    err = None
    if not cross:
        v = _combine(lo, hi, mode)
        if want_err:
            err = torch.sum((lo - hi) ** 2)
        set_plane(a, axis, 1, v)
        set_plane(a, axis, n + 1, v)
        return err
    # vpic_tpu/ops/fields.py:481-540: my lo partner's high plane, my hi
    # partner's low plane
    from ..parallel.mesh import mesh_of
    m = mesh_of(g)
    recv_lo = m.ppermute(hi, _pairs(g, axis))
    recv_hi = m.ppermute(lo, _pairs(g, axis + 3))
    bc = _rank_bc(g)
    j_lo, j_hi = bc[axis] == REMOTE, bc[axis + 3] == REMOTE
    # an unjoined rank of a locally periodic axis wraps (join tables only)
    wrap = (g.face_partners is not None and g.axis_bc(axis, -1) == PERIODIC
            and g.axis_bc(axis, 1) == PERIODIC)
    base = _combine(lo, hi, mode) if wrap else None
    new_lo = _combine(lo, recv_lo, mode) if j_lo else \
        (base if wrap else lo)
    new_hi = _combine(hi, recv_hi, mode) if j_hi else \
        (base if wrap else hi)
    if want_err:
        if g.face_partners is None:
            # the JAX package's cartesian error sums every rank's both
            # faces (an edge rank's wrap neighbour included)
            err = torch.sum((lo - recv_lo) ** 2) + \
                torch.sum((hi - recv_hi) ** 2)
        else:
            err = torch.zeros((), dtype=lo.dtype, device=lo.device)
            if j_lo:
                err = err + torch.sum((lo - recv_lo) ** 2)
            if j_hi:
                err = err + torch.sum((hi - recv_hi) ** 2)
    set_plane(a, axis, 1, new_lo)
    set_plane(a, axis, n + 1, new_hi)
    return err


def all_sum(x, g: Grid):
    """mp_allsum analogue: the sum over every rank (``Mesh.all_sum``);
    identity on an undecomposed grid."""
    if not g.sharded:
        return x
    from ..parallel.mesh import mesh_of
    return mesh_of(g).all_sum(x)


def synchronize_jf(f: FieldState, g: Grid) -> FieldState:
    """synchronize_jf (remote.c:417-508): local adjust then shared-face sum
    of the tangential current components."""
    adjust_jf(f, g)
    for axis, cross in _sync_axes(g):
        for t in _axes_of(axis):
            _combine_shared(getattr(f, _JF[t]), axis, g, cross, "sum")
    return f


def synchronize_rho(f: FieldState, g: Grid) -> FieldState:
    """synchronize_rho (remote.c:534-619): local adjust; shared-face rhof sum
    and rhob average (rhob is accumulated locally pre-doubled)."""
    adjust_rhof(f, g)
    adjust_rhob(f, g)
    for axis, cross in _sync_axes(g):
        _combine_shared(f.rhof, axis, g, cross, "sum")
        _combine_shared(f.rhob, axis, g, cross, "avg")
    return f


def synchronize_tang_e_norm_b(f: FieldState, g: Grid):
    """synchronize_tang_e_norm_b (remote.c:298-415): adjusts, then averages
    shared-face normal cB and tangential E/TCA; returns (fields, 0-d
    desynchronization error)."""
    adjust_tang_e(f, g)
    adjust_norm_b(f, g)
    err = torch.zeros((), dtype=torch.float32, device=f.ex.device)
    for axis, cross in _sync_axes(g):
        err = err + _combine_shared(getattr(f, _CB[axis]), axis, g, cross,
                                    "avg", want_err=True)
        for t in _axes_of(axis):
            err = err + _combine_shared(getattr(f, _E[t]), axis, g, cross,
                                        "avg", want_err=True)
            _combine_shared(getattr(f, _TCA[t]), axis, g, cross, "avg")
    return f, all_sum(err, g)


# ---------------------------------------------------------------------------
# advance_b (advance_b_pipeline.h:57-59 + boundary planes)
# ---------------------------------------------------------------------------

def advance_b(f: FieldState, g: Grid, frac: float) -> FieldState:
    """Faraday (half/full) step: cB -= frac*c*dt * curl E, over the interior
    plus the high boundary plane (as vpic_tpu.ops.fields.advance_b)."""
    px = frac * g.cvac * g.dt * g.rdx if g.gnx > 1 else 0.0
    py = frac * g.cvac * g.dt * g.rdy if g.gny > 1 else 0.0
    pz = frac * g.cvac * g.dt * g.rdz if g.gnz > 1 else 0.0
    ex, ey, ez = f.ex, f.ey, f.ez

    dcbx = (py * (ez[_sl3(INT, HI, INTH)] - ez[_sl3(INT, INT, INTH)])
            - pz * (ey[_sl3(HI, INT, INTH)] - ey[_sl3(INT, INT, INTH)]))
    f.cbx[_sl3(INT, INT, INTH)] -= dcbx

    dcby = (pz * (ex[_sl3(HI, INTH, INT)] - ex[_sl3(INT, INTH, INT)])
            - px * (ez[_sl3(INT, INTH, HI)] - ez[_sl3(INT, INTH, INT)]))
    f.cby[_sl3(INT, INTH, INT)] -= dcby

    dcbz = (px * (ey[_sl3(INTH, INT, HI)] - ey[_sl3(INTH, INT, INT)])
            - py * (ex[_sl3(INTH, HI, INT)] - ex[_sl3(INTH, INT, INT)]))
    f.cbz[_sl3(INTH, INT, INT)] -= dcbz
    return f


# ---------------------------------------------------------------------------
# advance_e (advance_e_pipeline.h:50-76)
# ---------------------------------------------------------------------------

def _curl_b_terms(f: FieldState, m: MaterialCoeffs, px, py, pz):
    """The three TCA curl terms over their edge extents (without damping)."""
    t = _sl3(INTH, INTH, INT)
    ym = _sl3(INTH, LOH, INT)
    zm = _sl3(LOH, INTH, INT)
    cx = (py * (f.cbz[t] * _slc(m.rmuz, t) - f.cbz[ym] * _slc(m.rmuz, ym))
          - pz * (f.cby[t] * _slc(m.rmuy, t) - f.cby[zm] * _slc(m.rmuy, zm)))
    t = _sl3(INTH, INT, INTH)
    zm = _sl3(LOH, INT, INTH)
    xm = _sl3(INTH, INT, LOH)
    cy = (pz * (f.cbx[t] * _slc(m.rmux, t) - f.cbx[zm] * _slc(m.rmux, zm))
          - px * (f.cbz[t] * _slc(m.rmuz, t) - f.cbz[xm] * _slc(m.rmuz, xm)))
    t = _sl3(INT, INTH, INTH)
    xm = _sl3(INT, INTH, LOH)
    ym = _sl3(INT, LOH, INTH)
    cz = (px * (f.cby[t] * _slc(m.rmuy, t) - f.cby[xm] * _slc(m.rmuy, xm))
          - py * (f.cbx[t] * _slc(m.rmux, t) - f.cbx[ym] * _slc(m.rmux, ym)))
    return cx, cy, cz


_EDGE = (_sl3(INTH, INTH, INT), _sl3(INTH, INT, INTH), _sl3(INT, INTH, INTH))


def advance_e(f: FieldState, g: Grid, m: MaterialCoeffs,
              damp: float = 0.0) -> FieldState:
    """Advance E a full step: fill tang-B ghosts, update every E edge
    (interior + boundary planes), then local_adjust_tang_e
    (advance_e_pipeline.cc:60-210)."""
    ghost_tang_b(f, g)
    px = (1 + damp) * g.cvac * g.dt * g.rdx if g.gnx > 1 else 0.0
    py = (1 + damp) * g.cvac * g.dt * g.rdy if g.gny > 1 else 0.0
    pz = (1 + damp) * g.cvac * g.dt * g.rdz if g.gnz > 1 else 0.0
    cj = g.dt / g.eps0
    curls = _curl_b_terms(f, m, px, py, pz)
    decay = (m.decayx, m.decayy, m.decayz)
    drive = (m.drivex, m.drivey, m.drivez)
    for ax in range(3):
        t = _EDGE[ax]
        tca = getattr(f, _TCA[ax])
        e = getattr(f, _E[ax])
        jf = getattr(f, _JF[ax])
        new_tca = curls[ax] - damp * tca[t]
        new_e = (_slc(decay[ax], t) * e[t]
                 + _slc(drive[ax], t) * (new_tca - cj * jf[t]))
        tca[t] = new_tca
        e[t] = new_e
    return adjust_tang_e(f, g)


def compute_curl_b(f: FieldState, g: Grid, m: MaterialCoeffs) -> FieldState:
    """compute_curl_b (init: seed TCA from curl B without damping/E update)."""
    px = g.cvac * g.dt * g.rdx if g.gnx > 1 else 0.0
    py = g.cvac * g.dt * g.rdy if g.gny > 1 else 0.0
    pz = g.cvac * g.dt * g.rdz if g.gnz > 1 else 0.0
    ghost_tang_b(f, g)
    curls = _curl_b_terms(f, m, px, py, pz)
    for ax in range(3):
        getattr(f, _TCA[ax])[_EDGE[ax]] = curls[ax]
    return adjust_tang_e(f, g)


# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

def clear_jf(f: FieldState) -> FieldState:
    f.jfx.zero_()
    f.jfy.zero_()
    f.jfz.zero_()
    return f


def clear_rhof(f: FieldState) -> FieldState:
    f.rhof.zero_()
    return f


# ---------------------------------------------------------------------------
# Divergence cleaning (Marder passes)
# ---------------------------------------------------------------------------

_NODE = _sl3(INTH, INTH, INTH)
_NODE_M = (_sl3(INTH, INTH, LOH), _sl3(INTH, LOH, INTH), _sl3(LOH, INTH, INTH))


def _div_eps_e(f: FieldState, m: MaterialCoeffs, px, py, pz):
    t = _NODE
    xm, ym, zm = _NODE_M
    return (px * (_slc(m.epsx, t) * f.ex[t] - _slc(m.epsx, xm) * f.ex[xm])
            + py * (_slc(m.epsy, t) * f.ey[t] - _slc(m.epsy, ym) * f.ey[ym])
            + pz * (_slc(m.epsz, t) * f.ez[t] - _slc(m.epsz, zm) * f.ez[zm]))


def compute_div_e_err(f: FieldState, g: Grid, m: MaterialCoeffs) -> FieldState:
    """compute_div_e_err_pipeline.h:48-52 over every node 1..n+1."""
    ghost_norm_e(f, g)
    px = g.rdx if g.gnx > 1 else 0.0
    py = g.rdy if g.gny > 1 else 0.0
    pz = g.rdz if g.gnz > 1 else 0.0
    cj = 1.0 / g.eps0
    t = _NODE
    f.div_e_err[t] = _slc(m.nonconductive, t) * (
        _div_eps_e(f, m, px, py, pz) - cj * (f.rhof[t] + f.rhob[t]))
    return adjust_div_e_err(f, g)


def compute_rhob(f: FieldState, g: Grid, m: MaterialCoeffs) -> FieldState:
    """compute_rhob_pipeline.h:47-51: rhob = div(eps eps0 E) - rhof at nodes."""
    ghost_norm_e(f, g)
    px = g.eps0 * g.rdx if g.gnx > 1 else 0.0
    py = g.eps0 * g.rdy if g.gny > 1 else 0.0
    pz = g.eps0 * g.rdz if g.gnz > 1 else 0.0
    t = _NODE
    f.rhob[t] = _slc(m.nonconductive, t) * (
        _div_eps_e(f, m, px, py, pz) - f.rhof[t])
    return adjust_rhob(f, g)


def compute_rms_div_e_err(f: FieldState, g: Grid):
    """RMS div-E error with half/quarter weights on shared/boundary nodes
    (compute_rms_div_e_err_pipeline.c:70-140): returns (num, den)."""
    e = f.div_e_err[_NODE] ** 2
    w = 1.0
    for axis in range(3):
        wax = torch.ones((e.shape[_arr_axis(axis)],), dtype=torch.float32,
                         device=e.device)
        wax[0] = 0.5
        wax[-1] = 0.5
        shape = [1, 1, 1]
        shape[_arr_axis(axis)] = -1
        w = w * wax.reshape(shape)
    num = torch.sum(e * w) * g.dV
    den = float(g.nx * g.ny * g.nz) * g.dV
    return num, den


def clean_div_e(f: FieldState, g: Grid, m: MaterialCoeffs) -> FieldState:
    """clean_div_e_pipeline.h:52-57 Marder pass over every E edge."""
    rdx = g.rdx if g.gnx > 1 else 0.0
    rdy = g.rdy if g.gny > 1 else 0.0
    rdz = g.rdz if g.gnz > 1 else 0.0
    alphadt = 0.3888889 / (rdx * rdx + rdy * rdy + rdz * rdz)
    px, py, pz = alphadt * rdx, alphadt * rdy, alphadt * rdz
    err = f.div_e_err

    t = _sl3(INTH, INTH, INT)
    f.ex[t] += _slc(m.drivex, t) * px * (err[_sl3(INTH, INTH, HI)] - err[t])
    t = _sl3(INTH, INT, INTH)
    f.ey[t] += _slc(m.drivey, t) * py * (err[_sl3(INTH, HI, INTH)] - err[t])
    t = _sl3(INT, INTH, INTH)
    f.ez[t] += _slc(m.drivez, t) * pz * (err[_sl3(HI, INTH, INTH)] - err[t])
    return f


def compute_div_b_err(f: FieldState, g: Grid) -> FieldState:
    """compute_div_b_err_pipeline.cc:45-47 over cells 1..n."""
    px = g.rdx if g.gnx > 1 else 0.0
    py = g.rdy if g.gny > 1 else 0.0
    pz = g.rdz if g.gnz > 1 else 0.0
    t = _sl3(INT, INT, INT)
    f.div_b_err[t] = (px * (f.cbx[_sl3(INT, INT, HI)] - f.cbx[t])
                      + py * (f.cby[_sl3(INT, HI, INT)] - f.cby[t])
                      + pz * (f.cbz[_sl3(HI, INT, INT)] - f.cbz[t]))
    return f


def compute_rms_div_b_err(f: FieldState, g: Grid):
    """Interior-cell RMS of div-B error (compute_rms_div_b_err_pipeline.c):
    returns (num, den)."""
    e = f.div_b_err[_sl3(INT, INT, INT)] ** 2
    num = torch.sum(e) * g.dV
    den = float(g.nx * g.ny * g.nz) * g.dV
    return num, den


def clean_div_b(f: FieldState, g: Grid) -> FieldState:
    """clean_div_b Marder pass: cb += alphadt * grad(div_b_err), faces 1..n+1."""
    ghost_div_b(f, g)
    rdx = g.rdx if g.gnx > 1 else 0.0
    rdy = g.rdy if g.gny > 1 else 0.0
    rdz = g.rdz if g.gnz > 1 else 0.0
    alphadt = 0.3888889 / (rdx * rdx + rdy * rdy + rdz * rdz)
    px, py, pz = alphadt * rdx, alphadt * rdy, alphadt * rdz
    err = f.div_b_err

    t = _sl3(INT, INT, INTH)
    f.cbx[t] += px * (err[t] - err[_sl3(INT, INT, LOH)])
    t = _sl3(INT, INTH, INT)
    f.cby[t] += py * (err[t] - err[_sl3(INT, LOH, INT)])
    t = _sl3(INTH, INT, INT)
    f.cbz[t] += pz * (err[t] - err[_sl3(LOH, INT, INT)])
    return adjust_norm_b(f, g)


# ---------------------------------------------------------------------------
# Field energies (energy_f_pipeline.h REDUCE_EN + 0.5*eps0*dV scaling)
# ---------------------------------------------------------------------------

def energy_f(f: FieldState, g: Grid, m: MaterialCoeffs):
    """The 6-vector [ex, ey, ez, bx, by, bz] of field energies (float32)."""
    def esum(a, eps, off1_axis, off2_axis):
        t = _sl3(INT, INT, INT)
        total = _slc(eps, t) * a[t] ** 2
        for offs in ((off1_axis,), (off2_axis,), (off1_axis, off2_axis)):
            sl = [INT, INT, INT]
            for ax in offs:
                sl[_arr_axis(ax)] = HI
            sl = tuple(sl)
            total = total + _slc(eps, sl) * a[sl] ** 2
        return 0.25 * torch.sum(total)

    def bsum(a, rmu, off_axis):
        t = _sl3(INT, INT, INT)
        sl = [INT, INT, INT]
        sl[_arr_axis(off_axis)] = HI
        sl = tuple(sl)
        return 0.5 * torch.sum(_slc(rmu, t) * a[t] ** 2
                               + _slc(rmu, sl) * a[sl] ** 2)

    v0 = 0.5 * g.eps0 * g.dV
    en = torch.stack([
        esum(f.ex, m.epsx, 1, 2),
        esum(f.ey, m.epsy, 2, 0),
        esum(f.ez, m.epsz, 0, 1),
        bsum(f.cbx, m.rmux, 0),
        bsum(f.cby, m.rmuy, 1),
        bsum(f.cbz, m.rmuz, 2),
    ])
    return v0 * en
