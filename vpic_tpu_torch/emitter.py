"""Emission models and device-side injection (counterpart of
``vpic_tpu/emitter.py``, src/emitter/).

The reference builds per-emitter component lists (32*cell + face
encodings, emitter.h:16-29) once at init by scanning deck region
predicates (deck/wrapper.h:310-383) and applies each emitter every step
after the push (advance.cc:58-60).  Here the component list is a pair of
static (voxel, face) arrays built on the host in numpy, equal to the JAX
package's; emission is a fixed-shape masked injection: every component
emits ``n_emit_per_face`` candidate lanes and those whose face is below
threshold are dropped.  On a decomposed grid every rank scans every
rank's brick with that brick's global offsets and the lists are padded to
the widest and stacked with leading (px, py, pz) dims and a validity mask
(vpic_tpu/emitter.py:28-110); the emitter takes this rank's row when it is
prepared.

Draw, then apply (as ``collision``): ``ChildLangmuir.draw(generator,
device)`` makes the six standard variates the JAX op draws;
``apply(species, fcoef, acc, rhob, g, draws)`` does the rest.  New lanes go
into the first free slots without reordering live lanes, their charge
into rhob (``ops/push.deposit_rhob``), and their random-age partial push
through ``ops/move_p.move_p`` (the ``move_p.cu`` kernel on the card, one
launch a call; the plain walk on the CPU), which sees the domain faces
only, as the JAX package's walk.  The walk's pend codes are dropped, as the
JAX package drops them: a new lane whose aged walk ends at a custom face,
or at a face another rank owns, stays parked on that face in its cell and
the next push moves it on (it is not handed to boundary_p).  Nothing
reads the device on the host: a step with emitters makes no synchronizing
operation.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .grid import FACE_AXIS, FACE_SIDE, Grid, flat_rank, rank_coords
from .ops.move_p import move_p
from .ops.push import DONE, deposit_rhob
from .state import SpeciesParams, SpeciesState

CHILD_LANGMUIR_NORM = 4.0 * math.sqrt(2.0) / 9.0  # Child law prefactor


def _region_inside(g: Grid, region: Callable, shard):
    """Rasterize the region predicate over ``shard``'s ghosted brick at the
    cell centres, in global coordinates (deck/wrapper.h:310-383: each rank
    scans with its own offsets).  Ghost cells at a seam between bricks take
    their true region value, so a surface crossing a seam is not detected
    there; ghost cells beyond the global domain are outside, so domain
    faces count as surface."""
    x0 = g.x0 + shard[0] * g.nx * g.dx
    y0 = g.y0 + shard[1] * g.ny * g.dy
    z0 = g.z0 + shard[2] * g.nz * g.dz
    xc = x0 + g.dx * (np.arange(g.NX) - 0.5)
    yc = y0 + g.dy * (np.arange(g.NY) - 0.5)
    zc = z0 + g.dz * (np.arange(g.NZ) - 0.5)
    Z, Y, X = np.meshgrid(zc, yc, xc, indexing="ij")
    inside = np.vectorize(region, otypes=[bool])(X, Y, Z)
    for ax, (n, gn, off) in enumerate((
            (g.NX, g.gnx, shard[0] * g.nx),
            (g.NY, g.gny, shard[1] * g.ny),
            (g.NZ, g.gnz, shard[2] * g.nz))):
        gi = off + np.arange(n) - 1          # global cell id per index
        edge = (gi < 0) | (gi >= gn)
        sl = [slice(None)] * 3
        sl[2 - ax] = edge                    # inside is [z, y, x]-ordered
        inside[tuple(sl)] = False
    return inside


def _shard_iter(g: Grid):
    """Every brick's (sx, sy, sz), x-major and z-minor (flat rank order)."""
    px, py, pz = g.topology
    for sx in range(px):
        for sy in range(py):
            for sz in range(pz):
                yield (sx, sy, sz)


def _pack_sharded(g: Grid, per_shard):
    """The bricks' (vox, face) lists padded to the longest (at least 1) and
    stacked with leading topology dims: (vox, face, valid), each (px, py,
    pz, M), valid False in the padding."""
    M = max(1, max(len(v) for v, _ in per_shard))
    px, py, pz = g.topology
    vox = np.zeros((px, py, pz, M), np.int32)
    fac = np.zeros((px, py, pz, M), np.int32)
    val = np.zeros((px, py, pz, M), bool)
    for (sx, sy, sz), (v, f) in zip(_shard_iter(g), per_shard):
        vox[sx, sy, sz, :len(v)] = v
        fac[sx, sy, sz, :len(f)] = f
        val[sx, sy, sz, :len(v)] = True
    return vox, fac, val


def _surface_scan(g: Grid, region: Callable, shard):
    inside = _region_inside(g, region, shard)
    vox, faces = [], []
    offs = {0: (0, 0, -1), 1: (0, -1, 0), 2: (-1, 0, 0),
            3: (0, 0, 1), 4: (0, 1, 0), 5: (1, 0, 0)}  # [dz,dy,dx] per face
    interior = inside.copy()
    interior[0, :, :] = interior[-1, :, :] = False
    interior[:, 0, :] = interior[:, -1, :] = False
    interior[:, :, 0] = interior[:, :, -1] = False
    for (z, y, x) in np.argwhere(interior):
        for f, (dz, dy, dx) in offs.items():
            if not inside[z + dz, y + dy, x + dx]:
                vox.append(int(x + g.NX * (y + g.NY * z)))
                faces.append(f)
    return np.asarray(vox, np.int32), np.asarray(faces, np.int32)


def _volume_scan(g: Grid, region: Callable, shard):
    inside = _region_inside(g, region, shard)
    inside[0, :, :] = inside[-1, :, :] = False
    inside[:, 0, :] = inside[:, -1, :] = False
    inside[:, :, 0] = inside[:, :, -1] = False
    vox, faces = [], []
    for (z, y, x) in np.argwhere(inside):
        for f in range(6):
            vox.append(int(x + g.NX * (y + g.NY * z)))
            faces.append(f)
    return np.asarray(vox, np.int32), np.asarray(faces, np.int32)


def _components(scan, g: Grid, region: Callable, shard):
    if shard is not None:
        return scan(g, region, tuple(shard))
    if not g.sharded:
        return scan(g, region, (0, 0, 0))
    return _pack_sharded(g, [scan(g, region, s) for s in _shard_iter(g)])


def surface_components(g: Grid, region: Callable, shard=None):
    """The (voxel, face) components of the region's surface: faces of
    inside cells whose neighbour is outside or beyond the global domain
    (define_surface_emitter).  On a decomposed grid (``shard`` None) every
    brick is scanned and the result is the packed (vox, face, valid) of
    _pack_sharded; an explicit ``shard`` (sx, sy, sz) scans that brick."""
    return _components(_surface_scan, g, region, shard)


def volume_components(g: Grid, region: Callable, shard=None):
    """define_volume_emitter's scan (deck/wrapper.h:310-383): every face of
    every cell inside the region; decomposed grids as surface_components."""
    return _components(_volume_scan, g, region, shard)


# ---------------------------------------------------------------------------
# insertion into free slots (fixed shapes, no host read)
# ---------------------------------------------------------------------------

def free_slots(live: torch.Tensor, m: int) -> torch.Tensor:
    """The first ``m`` dead slots in slot order, padded with the capacity:
    the JAX package's ``nonzero(~live, size=m, fill_value=capacity)``,
    from a cumulative sum and a scatter into an (m + 1,) buffer whose last
    entry takes the dead slots past the m-th (no host read)."""
    cap = live.shape[0]
    dead = ~live
    rank = torch.cumsum(dead, 0) - 1
    dst = torch.where(dead & (rank < m), rank, m)
    out = torch.full((m + 1,), cap, dtype=torch.int64, device=live.device)
    out.scatter_(0, dst, torch.arange(cap, device=live.device))
    return out[:m]


def insertion_slots(sp: SpeciesState, valid: torch.Tensor):
    """(slot, n_new): the slot of each candidate lane (the capacity for a
    candidate that is not ``valid`` or finds no free slot) and the number
    inserted, a 0-d int32 tensor, min(sum(valid), capacity - np)."""
    cap = sp.capacity
    m = valid.shape[0]
    free = free_slots(sp.live, m)
    rank = torch.cumsum(valid, 0) - 1
    slot = torch.where(valid, free[torch.clamp(rank, 0, m - 1)], cap)
    n_new = torch.minimum(valid.sum(dtype=torch.int32), cap - sp.np)
    return slot, n_new


def insert(a: torch.Tensor, slot: torch.Tensor, v: torch.Tensor):
    """A new tensor: ``a`` with v[k] written at slot[k] (writes to the
    capacity are dropped, the JAX package's ``at[slot].set(v,
    mode="drop")``)."""
    ext = torch.cat((a, a.new_zeros(1)))
    ext.index_copy_(0, slot, v.to(a.dtype))
    return ext[:-1]


def _insert_species(sp: SpeciesState, slot, n_new, cols) -> SpeciesState:
    """The species with the candidate lanes' columns ``cols`` inserted at
    ``slot``; np grows by n_new."""
    return sp.replace(np=sp.np + n_new, **{
        n: insert(getattr(sp, n), slot, v) for n, v in cols.items()})


def _aged_walk(sp, slot, newmask, u, age, acc, rhob, g: Grid, qsp,
               max_streak):
    """The random-age partial push of the inserted lanes: displacement
    u * age * cvac * dt / gamma (in cells) walked by move_p with pend DONE
    (the JAX package's streak_walk at emitter.py:217-235)."""
    ux, uy, uz = u
    gam = torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
    aged = age * g.cvac * g.dt / gam
    disp = tuple(insert(torch.zeros_like(sp.dx), slot, c * aged * rd)
                 for c, rd in ((ux, g.rdx), (uy, g.rdy), (uz, g.rdz)))
    pend = torch.full((sp.capacity,), DONE, dtype=torch.int32,
                      device=sp.dx.device)
    sp, _, _, acc, rhob = move_p(sp, pend, disp, acc, rhob, g, qsp, newmask,
                                 max_streak)
    return sp, acc, rhob


# ---------------------------------------------------------------------------
# Child-Langmuir surface emission
# ---------------------------------------------------------------------------

class ChildLangmuir:
    """child_langmuir (child_langmuir.c:8-211): space-charge-limited (Child
    law) emission.  Per eligible face, n_emit_per_face macro particles with
    weight w = norm_axis sqrt(|E_n|^3), half-Maxwellian parallel momentum,
    a random position on the face, a random age (partial push), and -q into
    rhob.  Call: ``op(species, f, fcoef, acc, rhob, g, step, generator)``
    -> (species, acc, rhob); acc and rhob are updated in place.

    ``components`` is a (vox, face) pair, or on a decomposed grid the
    packed (vox, face, valid) of surface_components: then each rank emits
    from its own row, picked when the op is prepared, and ``M`` (the
    candidates of a call, the size of each draw) is the padded width, as
    the JAX op's per-shard shapes; padded candidates are never eligible."""

    def __init__(self, sp_idx: int, spp: SpeciesParams, components,
                 n_emit_per_face: int = 1, ut_para: float = 0.0,
                 ut_perp: float = 0.0, thresh_e_norm: float = 0.0,
                 norm: float = CHILD_LANGMUIR_NORM, max_streak: int = 4):
        comps = [np.asarray(c) for c in components]
        if len(comps) == 3:
            vox, face, valid = comps
            self.topology = vox.shape[:3]
            self.total = int(valid.sum())
        else:
            (vox, face), valid = comps, None
            self.topology = None
            self.total = vox.shape[-1]
        self.sp_idx, self.spp = sp_idx, spp
        self.n_emit = n_emit_per_face
        self.ut_para, self.ut_perp = ut_para, ut_perp
        self.thresh = thresh_e_norm
        self.norm, self.max_streak = norm, max_streak
        rep = lambda a: np.repeat(a, n_emit_per_face, axis=-1)
        self._host = dict(vox=rep(vox).astype(np.int64),
                          axis=np.asarray(FACE_AXIS, np.int64)[rep(face)],
                          side=np.asarray(FACE_SIDE, np.int64)[rep(face)])
        if valid is not None:
            self._host["valid"] = rep(valid)
        self.M = self._host["vox"].shape[-1]
        self._dev = {}

    def _row(self, g: Grid):
        """This rank's (sx, sy, sz) row of packed components, or () for a
        pair; raises when the packed rows are not the grid's topology."""
        if self.topology is None:
            return ()
        if g is None or tuple(self.topology) != tuple(g.topology):
            raise ValueError(
                f"packed emitter components of topology {self.topology} "
                "need a grid of that topology, got "
                f"{None if g is None else g.topology}")
        return rank_coords(g, flat_rank(g))

    def prepare(self, device, g: Grid = None):
        """The component arrays of this rank (its row of packed components;
        ``g`` is needed then) on ``device``, copied once per device and row:
        the step calls this before its first step, so no step copies from
        the host."""
        device = torch.device(device)
        row = self._row(g)
        key = (device, row)
        if key not in self._dev:
            h = {k: v[row] for k, v in self._host.items()}
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            side = t(h["side"])
            self._dev[key] = dict(
                vox=t(h["vox"]), axis=t(h["axis"]),
                valid=t(h["valid"]) if "valid" in h else None,
                # emission direction: the inward normal (low faces emit +)
                dirn=torch.where(side < 0, 1.0, -1.0))
        return self._dev[key]

    def draw(self, generator, device) -> dict:
        """The six standard variates of one call, (M,) float32 each (the
        JAX op's k1..k6, emitter.py:155-219)."""
        m = self.M
        kinds = (("par", "uniform"), ("perp1", "normal"),
                 ("perp2", "normal"), ("pos1", "uniform"),
                 ("pos2", "uniform"), ("age", "uniform"))
        out = {}
        for name, kind in kinds:
            fn = torch.rand if kind == "uniform" else torch.randn
            out[name] = fn((m,), generator=generator, device=device)
        return out

    def apply(self, species, fcoef, acc, rhob, g: Grid, draws):
        species = list(species)
        k = self.sp_idx
        sp = species[k]
        if self.total == 0:
            return species, acc, rhob
        c = self.prepare(sp.dx.device, g)
        vox, axis, dirn = c["vox"], c["axis"], c["dirn"]
        q, m = self.spp.q, self.spp.m
        # the normal E at the face: ex, ey, ez coefficient columns 0, 4, 8
        e_n = fcoef[vox, 4 * axis]
        eligible = dirn * q * e_n > abs(q) * self.thresh
        if c["valid"] is not None:
            eligible = eligible & c["valid"]
        pref = (self.norm * g.eps0 * g.dt) / (math.sqrt(abs(q * m))
                                               * self.n_emit)
        na = np.float32([pref * math.sqrt(g.rdx) * g.dy * g.dz,
                         pref * math.sqrt(g.rdy) * g.dz * g.dx,
                         pref * math.sqrt(g.rdz) * g.dx * g.dy])
        norm_ax = torch.where(axis == 0, float(na[0]), torch.where(
            axis == 1, float(na[1]), float(na[2])))
        a3 = e_n.abs()
        w = torch.where(eligible, norm_ax * torch.sqrt(a3 * a3 * a3), 0.0)

        # momenta: half-Maxwellian parallel + thermal perpendicular
        u_par = dirn * self.ut_para * torch.sqrt(
            2.0 * -torch.log(torch.clamp(draws["par"], min=1e-37)))
        u_p1 = self.ut_perp * draws["perp1"]
        u_p2 = self.ut_perp * draws["perp2"]
        # positions: on the emitting face, random transverse offsets
        r1 = 2.0 * draws["pos1"] - 1.0
        r2 = 2.0 * draws["pos2"] - 1.0
        u, pos = [], []
        for a in range(3):
            along, next_ = axis == a, (axis + 1) % 3 == a
            u.append(torch.where(along, u_par,
                                 torch.where(next_, u_p1, u_p2)))
            pos.append(torch.where(along, -dirn,
                                   torch.where(next_, r1, r2)))

        # into dead slots WITHOUT reordering live lanes
        slot, n_new = insertion_slots(sp, eligible)
        sp = _insert_species(sp, slot, n_new, dict(
            dx=pos[0], dy=pos[1], dz=pos[2], i=vox, ux=u[0], uy=u[1],
            uz=u[2], w=w, live=eligible))
        newmask = insert(torch.zeros_like(sp.live), slot, eligible)
        deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w, -q, newmask)

        sp, acc, rhob = _aged_walk(sp, slot, newmask, u, draws["age"], acc,
                                   rhob, g, q, self.max_streak)
        species[k] = sp
        return species, acc, rhob

    def __call__(self, species, f, fcoef, acc, rhob, g: Grid, step,
                 generator):
        if self.total == 0:
            return list(species), acc, rhob
        draws = self.draw(generator, species[self.sp_idx].dx.device)
        return self.apply(species, fcoef, acc, rhob, g, draws)


# the emitter factory decks hand define_surface_emitter (vpic_tpu's name)
child_langmuir = ChildLangmuir


# ---------------------------------------------------------------------------
# runtime injection
# ---------------------------------------------------------------------------

def _conv(v: torch.Tensor, v0: float, v1: float, n: int):
    """Global coordinate -> (offset in [-1, 1], ghosted cell index) in
    float64, the host staging's conversion (misc.cc:16-100); a landing on
    the domain's far edge is offset 1 in cell n.  The quotient is one
    rounding, as on the host (on the card torch divides by a Python number
    as a product with its reciprocal)."""
    d = v.to(torch.float64) - v0
    s = float(n) * (d / torch.full_like(d, v1 - v0))
    iv = torch.floor(s)
    frac = s - iv
    frac = torch.where(iv >= n, 1.0, torch.where(iv < 0, 0.0, frac))
    iv = torch.clamp(iv, 0, n - 1)
    return ((frac + frac) - 1.0).to(torch.float32), iv.to(torch.int64) + 1


def runtime_inject(sp: SpeciesState, g: Grid, acc, rhob, x, y, z, ux, uy,
                   uz, w, qsp, age=None, update_rhob: bool = False,
                   max_streak: int = 4):
    """Device-side inject_particle (misc.cc:16-100) for
    user_particle_injection hooks: global coordinates -> (voxel, offset),
    optional rhob bookkeeping and the aged partial push (move_p).  Every
    argument is a fixed-size (M,) tensor; lanes with w < 0 are skipped (the
    fixed-shape analogue of conditional injection).  The conversion runs in
    float64 on the device, as the host staging does, where the JAX package
    emulates it with float32 pairs.  Returns (species, acc, rhob); acc and
    rhob are updated in place.

    On a decomposed grid every rank makes the call with the same lanes and
    keeps those whose global cell lies in its brick, converted to its local
    voxels (VPIC's inject_particle injects only into the local domain, as
    the deck's staging keeps a rank's lanes); the others are skipped as
    w < 0 lanes are.  The JAX package's op instead builds the local voxel
    from the global cell, so under shard_map every shard inserts every
    lane (ROADMAP Queue 3, "runtime_inject on a decomposed grid")."""
    valid = w >= 0
    dx, ix = _conv(x, g.x0, g.x1, g.gnx)
    dy, iy = _conv(y, g.y0, g.y1, g.gny)
    dz, iz = _conv(z, g.z0, g.z1, g.gnz)
    if g.sharded:
        co = []
        for c, s_, n in zip((ix, iy, iz), rank_coords(g, flat_rank(g)),
                            (g.nx, g.ny, g.nz)):
            c = c - s_ * n
            valid = valid & (c >= 1) & (c <= n)
            co.append(c)
        ix, iy, iz = co
    vox = (ix + g.NX * (iy + g.NY * iz)).to(torch.int32)
    slot, n_new = insertion_slots(sp, valid)
    sp = _insert_species(sp, slot, n_new, dict(
        dx=dx, dy=dy, dz=dz, i=vox, ux=ux, uy=uy, uz=uz,
        w=torch.clamp(w, min=0.0), live=valid))
    newmask = insert(torch.zeros_like(sp.live), slot, valid)
    if update_rhob:
        deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w, -qsp, newmask)
    if age is not None:
        sp, acc, rhob = _aged_walk(sp, slot, newmask, (ux, uy, uz), age,
                                   acc, rhob, g, qsp, max_streak)
    return sp, acc, rhob
