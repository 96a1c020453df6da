"""Particle engine, general path: interpolate -> Boris push -> streak walk
-> current deposition (counterpart of ``vpic_tpu/ops/push.py``).

Every particle runs the same bounded streak walk (move_p.cc:216-353): an
in-bounds particle finishes on the first sub-streak with the inline
ACCUMULATE_J deposits, crossers take up to ``max_streak`` masked
sub-streaks.  Deposits go through ``index_add_`` on a long voxel index into
one (nv, 12) quarter-face accumulator.  This module is also the plain
version of the hand-written push kernels (``ops/fused_push.py``,
``ops/fused_push3d.py``).

Particle faces: periodic and reflecting faces are walked through; at an
absorbing face the lane dies and its charge goes to rhob; at a custom face
(ids <= FIRST_CUSTOM_PBC) the lane is parked for ``boundary.boundary_p``
with pend = CUSTOM_BASE + face and its remaining displacement; on a
decomposed grid a rank's REMOTE face (``grid.rank_particle_bc``: a face a
neighbouring rank owns) parks it with pend = face, for the migration
rounds of ``boundary.boundary_p`` (vpic_tpu/ops/push.py:505-553).  A
per-voxel-face code table ``vbc`` (set_region_particle_bc) overrides the
domain rule at the faces it marks.

All arithmetic is float32 in the JAX package's operation order.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..grid import (ABSORB_PARTICLES, P_PERIODIC, P_REMOTE,
                    REFLECT_PARTICLES, Grid, flat_rank, rank_particle_bc)
from ..state import SpeciesState

ONE_THIRD = 1.0 / 3.0
TWO_FIFTEENTHS = 2.0 / 15.0
BIG = 3.4e38

# pend_face codes: -1 = finished locally, 0..5 = left through that face
# toward another rank (decomposed runs only), 6 = ran out of streak
# iterations, >= 8 = parked at a custom particle BC: CUSTOM_BASE + face for
# a domain face, CUSTOM_BASE + 6 + 6 h + face for region handler h.
DONE = -1
UNFINISHED = 6
CUSTOM_BASE = 8


class PushResult(NamedTuple):
    species: SpeciesState
    acc: torch.Tensor         # (nv, 12) quarter-face current accumulator
    rhob_flat: torch.Tensor   # (nv,) flat rhob including absorb deposits
    pend_face: torch.Tensor   # (N,) int32, see codes above
    pend_disp: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    n_pend: torch.Tensor      # 0-d int32: lanes parked at a remote face


def particle_bcs(g: Grid):
    """This rank's six particle face codes: the grid's own on an
    undecomposed grid, ``grid.rank_particle_bc`` on a decomposed one."""
    return rank_particle_bc(g, flat_rank(g)) if g.sharded else g.particle_bc


def check_particle_bcs(g: Grid):
    """Raise for faces no walk can serve: a remote face on an undecomposed
    grid (there is no rank to migrate to), and a P_REMOTE face with a rank
    that has no partner in the join tables (its leavers would vanish; the
    JAX package's initialize() refuses it too)."""
    if not g.sharded:
        for face, bc in enumerate(g.particle_bc):
            if bc == P_REMOTE:
                raise NotImplementedError(
                    f"particle bc {bc} (remote) on face {face} of an "
                    "undecomposed grid: migration needs a decomposed run")
        return
    if g.face_partners is not None:
        for face, bc in enumerate(g.particle_bc):
            bad = [r for r, p in enumerate(g.face_partners[face]) if p < 0]
            if bc == P_REMOTE and bad:
                raise ValueError(
                    f"face {face} has particle bc P_REMOTE but ranks {bad} "
                    "are unjoined in the domain graph: their leaving "
                    "particles would be lost.  join_domain() every rank's "
                    "face or set its particle BC first.")


def has_walls(g: Grid, vbc=None) -> bool:
    """True when a push on ``g`` needs each face's own rule: an absorbing,
    custom or remote face of this rank (a lane can die or park), an axis
    periodic on one side only, or a per-voxel-face table."""
    bcs = particle_bcs(g)
    periodic = [bc == P_PERIODIC for bc in bcs]
    return vbc is not None or periodic[:3] != periodic[3:] or any(
        bc not in (P_PERIODIC, REFLECT_PARTICLES) for bc in bcs)


class Walls:
    """What a push with wall faces reads and writes besides the lanes and
    the accumulator (see has_walls).  In: ``rhob``, the (nv,) float32 flat
    rhob that absorbed lanes deposit into in place, and ``vbc``, the
    (nv, 6) int32 per-voxel-face code table or None.  Out, set by the
    push: ``pends``, one (N,) int32 pend code array per species, and
    ``disps``, one (3, N) float32 remaining displacement per species.  Only
    the lanes live when the push began have them: the kernels leave the
    other slots unwritten (the plain versions put DONE and 0 there), so a
    reader masks them with the live flags."""

    def __init__(self, rhob: torch.Tensor, vbc: Optional[torch.Tensor] = None):
        self.rhob = rhob
        self.vbc = vbc
        self.pends: List[torch.Tensor] = []
        self.disps: List[torch.Tensor] = []


def decode_voxel(i: torch.Tensor, g: Grid):
    """(x, y, z) int32 coordinates of linear voxel indices."""
    zi = torch.div(i, g.sz, rounding_mode="floor")
    r = i - zi * g.sz
    yi = torch.div(r, g.sy, rounding_mode="floor")
    return r - yi * g.sy, yi, zi


def _interp_fields(fcoef, dx, dy, dz, qdt_2mc):
    """Gathered-row interpolation (advance_p_pipeline.cc:93-106)."""
    hax = qdt_2mc * ((fcoef[:, 0] + dy * fcoef[:, 1])
                     + dz * (fcoef[:, 2] + dy * fcoef[:, 3]))
    hay = qdt_2mc * ((fcoef[:, 4] + dz * fcoef[:, 5])
                     + dx * (fcoef[:, 6] + dz * fcoef[:, 7]))
    haz = qdt_2mc * ((fcoef[:, 8] + dx * fcoef[:, 9])
                     + dy * (fcoef[:, 10] + dx * fcoef[:, 11]))
    cbx = fcoef[:, 12] + dx * fcoef[:, 13]
    cby = fcoef[:, 14] + dy * fcoef[:, 15]
    cbz = fcoef[:, 16] + dz * fcoef[:, 17]
    return hax, hay, haz, cbx, cby, cbz


def _boris_rotate(ux, uy, uz, cbx, cby, cbz, qdt_2mc_or_4mc):
    """Relativistic Boris rotation with the reference's tan(theta/2)
    expansion (advance_p_pipeline.cc:117-132)."""
    v0 = qdt_2mc_or_4mc * torch.rsqrt(1.0 + (ux * ux + (uy * uy + uz * uz)))
    v1 = cbx * cbx + (cby * cby + cbz * cbz)
    v2 = (v0 * v0) * v1
    v3 = v0 * (1.0 + v2 * (ONE_THIRD + v2 * TWO_FIFTEENTHS))
    v4 = v3 / (1.0 + v1 * (v3 * v3))
    v4 = v4 + v4
    w0 = ux + v3 * (uy * cbz - uz * cby)
    w1 = uy + v3 * (uz * cbx - ux * cbz)
    w2 = uz + v3 * (ux * cby - uy * cbx)
    ux = ux + v4 * (w1 * cbz - w2 * cby)
    uy = uy + v4 * (w2 * cbx - w0 * cbz)
    uz = uz + v4 * (w0 * cby - w1 * cbx)
    return ux, uy, uz


def _accumulate_j_cols(q, sdx, sdy, sdz, midx, midy, midz):
    """The (N, 12) quarter-face current values for one sub-streak
    (ACCUMULATE_J, advance_p_pipeline.cc:183-207 == move_p.cc:276-297)."""
    v5 = q * sdx * sdy * sdz * ONE_THIRD

    def one(qu, dY, dZ):
        v1 = qu * dY
        v0 = qu - v1
        v1 = v1 + qu
        a = 1.0 + dZ
        v2 = v0 * a
        v3 = v1 * a
        b = 1.0 - dZ
        v0 = v0 * b
        v1 = v1 * b
        return (v0 + v5, v1 - v5, v2 - v5, v3 + v5)

    jx = one(q * sdx, midy, midz)
    jy = one(q * sdy, midz, midx)
    jz = one(q * sdz, midx, midy)
    return torch.stack(jx + jy + jz, dim=-1)


def _trilinear_weights(dx, dy, dz, q):
    """8 node weights in VPIC's order (rho_p.cc:70-75):
    [(-,-,-),(+,-,-),(-,+,-),(+,+,-),(-,-,+),(+,-,+),(-,+,+),(+,+,+)]."""
    w6 = q - dx * q
    w7 = q + dx * q
    w4 = w6 - dy * w6
    w5 = w7 - dy * w7
    w6 = w6 + dy * w6
    w7 = w7 + dy * w7
    w0 = w4 - dz * w4
    w1 = w5 - dz * w5
    w2 = w6 - dz * w6
    w3 = w7 - dz * w7
    w4 = w4 + dz * w4
    w5 = w5 + dz * w5
    w6 = w6 + dz * w6
    w7 = w7 + dz * w7
    return torch.stack([w0, w1, w2, w3, w4, w5, w6, w7], dim=-1)


def _node_bits(device):
    """(bx, by, bz) of the 8 trilinear nodes in VPIC's order, as int64
    device tensors made on the device (no copy from the host, which would
    synchronize the stream)."""
    j = torch.arange(8, dtype=torch.int64, device=device)
    return j & 1, (j >> 1) & 1, j >> 2


def deposit_rhob(rhob_flat, g: Grid, i, dx, dy, dz, w, qsp, mask):
    """accumulate_rhob (rho_p.cc:126-211): trilinear node deposit with the
    boundary-corrected doubling of weights on domain-edge nodes, added to
    ``rhob_flat`` in place (nodes past the mesh are dropped)."""
    q = torch.where(mask, qsp * g.r8V * w, 0.0)
    weights = _trilinear_weights(dx, dy, dz, q)
    x, y, z = decode_voxel(i, g)
    dev = weights.device
    bx, by, bz = _node_bits(dev)
    # 1 on the nodes at the low side of each axis
    xlo, ylo, zlo = ((b == 0).to(torch.float32)[None, :]
                     for b in (bx, by, bz))
    weights = weights * torch.where((z == 1)[:, None], 1.0 + zlo, 1.0)
    weights = weights * torch.where((z == g.nz)[:, None], 2.0 - zlo, 1.0)
    weights = weights * torch.where((y == 1)[:, None], 1.0 + ylo, 1.0)
    weights = weights * torch.where((y == g.ny)[:, None], 2.0 - ylo, 1.0)
    weights = weights * torch.where((x == 1)[:, None], 1.0 + xlo, 1.0)
    weights = weights * torch.where((x == g.nx)[:, None], 2.0 - xlo, 1.0)

    offsets = bx + g.sy * by + g.sz * bz
    nodes = (i.long()[:, None] + offsets[None, :]).reshape(-1)
    weights = weights.reshape(-1)
    keep = nodes < g.nv
    rhob_flat.index_add_(0, torch.where(keep, nodes, 0),
                         torch.where(keep, weights, 0.0))
    return rhob_flat


def accumulate_rho_p(rhof_flat, sp: SpeciesState, g: Grid, qsp):
    """accumulate_rho_p (rho_p.cc:22-112): uncorrected trilinear deposit of
    all live particles, added to flat ``rhof_flat`` in place.

    Cell-moment form, as the JAX package computes it: one (N, 8) row
    index_add of q*(1, dx, dy, dz, dxdy, dxdz, dydz, dxdydz) per cell, then
    the node values from 8 shifted dense adds."""
    q = torch.where(sp.live, qsp * g.r8V * sp.w, 0.0)
    dx, dy, dz = sp.dx, sp.dy, sp.dz
    m = torch.stack([q, q * dx, q * dy, q * dz, q * (dx * dy), q * (dx * dz),
                     q * (dy * dz), q * (dx * (dy * dz))], dim=1)
    mom = torch.zeros((g.nv, 8), dtype=torch.float32, device=q.device)
    mom.index_add_(0, sp.i.long(), m)
    mom = mom.reshape(g.NZ, g.NY, g.NX, 8)
    rho = rhof_flat.reshape(g.NZ, g.NY, g.NX)
    for c in (0, 1):
        for b in (0, 1):
            for a in (0, 1):
                sx, sy, sz = 2 * a - 1, 2 * b - 1, 2 * c - 1
                contrib = (mom[..., 0] + sx * mom[..., 1]
                           + sy * mom[..., 2] + sz * mom[..., 3]
                           + (sx * sy) * mom[..., 4]
                           + (sx * sz) * mom[..., 5]
                           + (sy * sz) * mom[..., 6]
                           + (sx * sy * sz) * mom[..., 7])
                rho[c:, b:, a:] += contrib[:g.NZ - c, :g.NY - b, :g.NX - a]
    return rhof_flat


def streak_walk(g: Grid, qsp, w, pos, disp, coords, u, active, alive,
                pend, acc, rhob, max_streak: int, vbc=None):
    """The move_p streak walk (move_p.cc:216-353) over all lanes at once,
    with every face rule of this rank (push.py:361-601 of the JAX
    package).

    pos/disp/coords/u are (x, y, z) triples of (N,) tensors; deposits are
    added to ``acc`` and absorbed charge to ``rhob`` in place.  ``vbc`` is
    the (nv, 6) (or flat (nv*6,)) int32 per-voxel-face code table: 0 = the
    domain rule, REFLECT_PARTICLES, ABSORB_PARTICLES, or a ready-made pend
    code >= CUSTOM_BASE; it is read at the exit face of the lane's current
    voxel before any domain logic.  Returns the updated triples plus
    (alive, pend, acc, rhob); lanes still active after ``max_streak`` rounds
    get pend = UNFINISHED."""
    check_particle_bcs(g)
    bcs = particle_bcs(g)
    px, py, pz = pos
    dpx, dpy, dpz = disp
    xi, yi, zi = coords
    ux, uy, uz = u
    q0 = torch.where(alive, qsp * w, 0.0)
    NX, NY = g.NX, g.NY
    n_axes = (g.nx, g.ny, g.nz)
    vbc_flat = None if vbc is None else vbc.reshape(-1)

    for _ in range(max_streak):
        dirx = torch.where(dpx > 0, 1.0, -1.0)
        diry = torch.where(dpy > 0, 1.0, -1.0)
        dirz = torch.where(dpz > 0, 1.0, -1.0)
        v0 = torch.where(dpx == 0, BIG,
                         (dirx - px) / torch.where(dpx == 0, 1.0, dpx))
        v1 = torch.where(dpy == 0, BIG,
                         (diry - py) / torch.where(dpy == 0, 1.0, dpy))
        v2 = torch.where(dpz == 0, BIG,
                         (dirz - pz) / torch.where(dpz == 0, 1.0, dpz))

        # axis = index of the strictly smallest of (v0, v1, v2, 2.0): the
        # earlier axis wins ties, end-of-track wins all ties at 2.0
        # (move_p.cc:257-260)
        v3 = torch.full_like(v0, 2.0)
        axis = torch.full_like(xi, 3)
        for k, vk in enumerate((v0, v1, v2)):
            take = vk < v3
            v3 = torch.where(take, vk, v3)
            axis = torch.where(take, k, axis)
        frac = 0.5 * v3

        sdx = dpx * frac
        sdy = dpy * frac
        sdz = dpz * frac
        midx = px + sdx
        midy = py + sdy
        midz = pz + sdz

        vox = xi + NX * (yi + NY * zi)
        vals = _accumulate_j_cols(q0 * active.to(torch.float32),
                                  sdx, sdy, sdz, midx, midy, midz)
        acc.index_add_(0, vox.long(), vals)

        dpx = torch.where(active, dpx - sdx, dpx)
        dpy = torch.where(active, dpy - sdy, dpy)
        dpz = torch.where(active, dpz - sdz, dpz)
        px = torch.where(active, px + sdx + sdx, px)
        py = torch.where(active, py + sdy + sdy, py)
        pz = torch.where(active, pz + sdz + sdz, pz)

        crossing = active & (axis != 3)
        active = crossing

        # Put the crossing particle exactly on the face (move_p.cc:321-323).
        px = torch.where(crossing & (axis == 0), dirx, px)
        py = torch.where(crossing & (axis == 1), diry, py)
        pz = torch.where(crossing & (axis == 2), dirz, pz)

        # The per-voxel-face code of the exit face comes first (the
        # reference decodes its neighbor-table entry before any domain
        # logic, boundary_p.cc:196-255).
        code = None
        if vbc_flat is not None:
            dsel = torch.where(axis == 0, dirx,
                               torch.where(axis == 1, diry, dirz))
            face = (torch.where(axis < 3, axis, 0)
                    + torch.where(dsel > 0, 3, 0))
            idx = torch.clamp(vox.long() * 6 + face, 0,
                              vbc_flat.shape[0] - 1)
            code = torch.where(crossing, vbc_flat[idx], 0)

        pos3 = [px, py, pz]
        dp3 = [dpx, dpy, dpz]
        u3 = [ux, uy, uz]
        c3 = [xi, yi, zi]
        vb_absorbed = None
        for ax, d in enumerate((dirx, diry, dirz)):
            m = crossing & (axis == ax)
            if code is not None:
                vb_r = m & (code == REFLECT_PARTICLES)
                vb_a = m & (code == ABSORB_PARTICLES) & alive
                vb_p = m & (code >= CUSTOM_BASE)
                u3[ax] = torch.where(vb_r, -u3[ax], u3[ax])
                dp3[ax] = torch.where(vb_r, -dp3[ax], dp3[ax])
                # one rhob deposit for every region absorb of the round,
                # after the axes (the lanes' positions stay frozen)
                vb_absorbed = vb_a if vb_absorbed is None \
                    else vb_absorbed | vb_a
                alive = alive & ~vb_a
                pend = torch.where(vb_p, code, pend)
                active = active & ~(vb_a | vb_p)
                m = m & ~(vb_r | vb_a | vb_p)
            n_ax = n_axes[ax]
            coord = c3[ax]
            new_coord = coord + (d > 0).to(torch.int32) * 2 - 1
            out_lo = m & (new_coord < 1)
            out_hi = m & (new_coord > n_ax)
            inside = m & ~out_lo & ~out_hi
            coord = torch.where(inside, new_coord, coord)
            flip = inside
            for side, out_m in ((-1, out_lo), (1, out_hi)):
                face = ax + (0 if side < 0 else 3)
                bc = bcs[face]
                if bc == P_REMOTE:
                    # a neighbouring rank's face: the lane stays on it,
                    # parked for migration with its remaining displacement
                    pend = torch.where(out_m, face, pend)
                    active = active & ~out_m
                elif bc == P_PERIODIC:
                    coord = torch.where(out_m, n_ax if side < 0 else 1, coord)
                    flip = flip | out_m
                elif bc == REFLECT_PARTICLES:
                    # Reflect: flip momentum + remaining displacement; the
                    # particle stays on the wall and keeps walking
                    # (move_p.cc:327-334).
                    u3[ax] = torch.where(out_m, -u3[ax], u3[ax])
                    dp3[ax] = torch.where(out_m, -dp3[ax], dp3[ax])
                elif bc == ABSORB_PARTICLES:
                    # the lane dies on the face; its charge goes to rhob
                    # (the voxel is the one it is leaving)
                    rhob = deposit_rhob(rhob, g, xi + NX * (yi + NY * zi),
                                        pos3[0], pos3[1], pos3[2], w, qsp,
                                        out_m & alive)
                    alive = alive & ~out_m
                    active = active & ~out_m
                else:
                    # Custom particle BC (maxwellian_reflux, absorb_tally,
                    # ...): park for boundary_p with the face code.
                    pend = torch.where(out_m, CUSTOM_BASE + face, pend)
                    active = active & ~out_m
            c3[ax] = coord
            pos3[ax] = torch.where(flip, -pos3[ax], pos3[ax])
            if ax == 0:
                xi = coord
            elif ax == 1:
                yi = coord
        px, py, pz = pos3
        dpx, dpy, dpz = dp3
        ux, uy, uz = u3
        xi, yi, zi = c3
        if vb_absorbed is not None:
            rhob = deposit_rhob(rhob, g, xi + NX * (yi + NY * zi), px, py,
                                pz, w, qsp, vb_absorbed)

    pend = torch.where(active, UNFINISHED, pend)
    return ((px, py, pz), (dpx, dpy, dpz), (xi, yi, zi), (ux, uy, uz),
            alive, pend, acc, rhob)


def advance_p(sp: SpeciesState, fcoef, g: Grid, qsp: float, msp: float,
              acc, rhob_flat=None, max_streak: int = 4,
              vbc=None) -> PushResult:
    """One leapfrog step for one species.  ``acc`` is the shared (nv, 12)
    accumulator every species adds into and ``rhob_flat`` the (nv,) flat
    rhob absorbed lanes deposit into, both in place (None: a zeroed one is
    made); ``vbc`` the optional per-voxel-face code table.  The species
    comes back as new tensors, with the pend codes and remaining
    displacement of every lane."""
    qdt_2mc = (qsp * g.dt) / (2.0 * msp * g.cvac)
    cdt_dx = g.cvac * g.dt * g.rdx
    cdt_dy = g.cvac * g.dt * g.rdy
    cdt_dz = g.cvac * g.dt * g.rdz
    alive = sp.live
    if rhob_flat is None:
        rhob_flat = torch.zeros(g.nv, dtype=torch.float32,
                                device=sp.dx.device)

    dx, dy, dz = sp.dx, sp.dy, sp.dz
    rows = fcoef[sp.i.long()]
    hax, hay, haz, cbx, cby, cbz = _interp_fields(rows, dx, dy, dz, qdt_2mc)
    ux = sp.ux + hax
    uy = sp.uy + hay
    uz = sp.uz + haz
    ux, uy, uz = _boris_rotate(ux, uy, uz, cbx, cby, cbz, qdt_2mc)
    ux = ux + hax
    uy = uy + hay
    uz = uz + haz

    # Normalized half-displacement in voxel-offset units
    # (advance_p_pipeline.cc:142-151).
    rgamma = torch.rsqrt(1.0 + (ux * ux + (uy * uy + uz * uz)))
    dispx = ux * cdt_dx * rgamma
    dispy = uy * cdt_dy * rgamma
    dispz = uz * cdt_dz * rgamma

    pend0 = torch.full((sp.capacity,), DONE, dtype=torch.int32,
                       device=dx.device)
    (pos, disp, coords, u, alive, pend, acc, rhob_flat) = streak_walk(
        g, qsp, sp.w, (dx, dy, dz), (dispx, dispy, dispz),
        decode_voxel(sp.i, g), (ux, uy, uz), alive, alive, pend0, acc,
        rhob_flat, max_streak, vbc=vbc)

    vox = coords[0] + g.NX * (coords[1] + g.NY * coords[2])
    new_sp = sp.replace(
        dx=pos[0], dy=pos[1], dz=pos[2], i=vox,
        ux=u[0], uy=u[1], uz=u[2],
        w=torch.where(alive, sp.w, 0.0), live=alive,
        np=alive.sum(dtype=torch.int32))
    n_pend = ((pend >= 0) & (pend < UNFINISHED)).sum(dtype=torch.int32)
    return PushResult(new_sp, acc, rhob_flat, pend, disp, n_pend)


def center_p(sp: SpeciesState, fcoef, g: Grid, qsp, msp) -> SpeciesState:
    """center_p (center_p_pipeline.cc:16-100): u from time level t-1/2 to t:
    half E kick (qdt_2mc) then half Boris rotate (qdt_4mc)."""
    qdt_2mc = (qsp * g.dt) / (2.0 * msp * g.cvac)
    qdt_4mc = 0.5 * qdt_2mc
    rows = fcoef[sp.i.long()]
    hax, hay, haz, cbx, cby, cbz = _interp_fields(rows, sp.dx, sp.dy, sp.dz,
                                                  qdt_2mc)
    ux, uy, uz = sp.ux + hax, sp.uy + hay, sp.uz + haz
    ux, uy, uz = _boris_rotate(ux, uy, uz, cbx, cby, cbz, qdt_4mc)
    a = sp.live
    return sp.replace(ux=torch.where(a, ux, sp.ux),
                      uy=torch.where(a, uy, sp.uy),
                      uz=torch.where(a, uz, sp.uz))


def uncenter_p(sp: SpeciesState, fcoef, g: Grid, qsp, msp) -> SpeciesState:
    """uncenter_p (uncenter_p_pipeline.cc:16-98): u from t to t-1/2
    (backward half rotate then backward half kick)."""
    qdt_2mc = -(qsp * g.dt) / (2.0 * msp * g.cvac)
    qdt_4mc = 0.5 * qdt_2mc
    rows = fcoef[sp.i.long()]
    hax, hay, haz, cbx, cby, cbz = _interp_fields(rows, sp.dx, sp.dy, sp.dz,
                                                  qdt_2mc)
    ux, uy, uz = _boris_rotate(sp.ux, sp.uy, sp.uz, cbx, cby, cbz, qdt_4mc)
    ux, uy, uz = ux + hax, uy + hay, uz + haz
    a = sp.live
    return sp.replace(ux=torch.where(a, ux, sp.ux),
                      uy=torch.where(a, uy, sp.uy),
                      uz=torch.where(a, uz, sp.uz))


def energy_p(sp: SpeciesState, fcoef, g: Grid, qsp, msp):
    """energy_p (energy_p_pipeline.cc:17-68): time-centered total kinetic
    energy of the species, a 0-d float32 tensor."""
    qdt_2mc = (qsp * g.dt) / (2.0 * msp * g.cvac)
    rows = fcoef[sp.i.long()]
    hax, hay, haz, _, _, _ = _interp_fields(rows, sp.dx, sp.dy, sp.dz,
                                            qdt_2mc)
    v0 = sp.ux + hax
    v1 = sp.uy + hay
    v2 = sp.uz + haz
    usq = v0 * v0 + v1 * v1 + v2 * v2
    ke = (msp * sp.w) * (usq / (1.0 + torch.sqrt(1.0 + usq)))
    ke = torch.where(sp.live, ke, 0.0)
    return torch.sum(ke) * (g.cvac * g.cvac)


def gather_sp_rows(src, sp: SpeciesState):
    """The nine species columns permuted by per-output-slot source index
    ``src``; dead lanes come back with voxel 0 (as the JAX package's
    gather_sp_rows leaves them)."""
    live = sp.live[src]
    i = torch.where(live, sp.i[src], 0)
    return dict(dx=sp.dx[src], dy=sp.dy[src], dz=sp.dz[src], ux=sp.ux[src],
                uy=sp.uy[src], uz=sp.uz[src], w=sp.w[src], i=i, live=live)


def sort_p(sp: SpeciesState) -> SpeciesState:
    """Stable sort of the lanes by voxel, dead slots last
    (sort_p_pipeline.c)."""
    key = torch.where(sp.live, sp.i, torch.iinfo(torch.int32).max)
    order = torch.sort(key, stable=True).indices
    return sp.replace(**gather_sp_rows(order, sp))
