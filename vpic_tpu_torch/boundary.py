"""Particle boundary interaction and cross-rank migration (counterpart of
``vpic_tpu/boundary.py``, boundary_p.cc:36-518).

The push parks lanes that reach a custom particle BC with pend =
CUSTOM_BASE + face (``ops/push.py``) and their remaining displacement;
``boundary_p`` dispatches them to the deck's registered handlers
(``boundary_ops``: maxwellian_reflux, absorb_tally, link_boundary; the
particle_bc_t interact dispatch, boundary_p.cc:250-255), then drops the
lanes still parked with their charge into rhob (the reference's leftover
drop, advance.cc:78-101).

On a decomposed grid the push parks a lane that reaches a face another
rank owns with pend = face, and ``boundary_p`` runs ``num_comm_round``
migration rounds (``_migrate_round``, vpic_tpu/boundary.py:89-191): each
packs its movers as 13 float32 columns (the particle_injector_t record:
offsets, voxel coordinates, momentum, weight, remaining displacement) into
one buffer per remote face of at most ``mig_cap`` rows (max(64,
capacity * ``MIG_FRAC``)), sends it to the
face's partner and, when lanes arrive, compacts the live lanes to the
front, appends the arrivals with the coordinate flip of the face they
crossed, and walks them on through ``ops/move_p`` (a lane that leaves
again gets a fresh pend code for the next round).  The movers are found
with two device reads a round, and the row counts go first as host ints,
so only the rows in use are packed and travel.  Movers past
``mig_cap`` and arrivals past the capacity are dropped (the overflow
movers' charge into rhob, as the reference drops leftover movers) and
counted in ``n_dropped``.

Everything happens in place: the handlers, the rounds and the leftover
drop write the species' lane tensors; ``np`` is recounted as a new 0-d
tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from .grid import FACE_AXIS, FACE_SIDE, Grid, flat_rank, halo_partners
from .ops import move_p as MP
from .ops.push import (DONE, UNFINISHED, check_particle_bcs, decode_voxel,
                       deposit_rhob)
from .state import SpeciesState

LANE_NAMES = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live")
# a species' movers a face and round: max(64, capacity * MIG_FRAC); more
# are dropped (vpic_tpu/boundary.py:196's mig_frac default)
MIG_FRAC = 0.125


def _remote_faces(g: Grid):
    """The faces some rank migrates through (boundary.py:80-87)."""
    if not g.sharded:
        return []
    return [f for f in range(6) if any(p >= 0 for p in halo_partners(g)[f])]


def compact(sp: SpeciesState, *extra):
    """Stable partition in place: live slots to the front (the reference's
    backfill, boundary_p.cc:418-438, as one gather); ``extra`` (N,) or
    (k, N) tensors are permuted alike.  Returns the species with np
    recounted."""
    live = sp.live
    n = live.shape[0]
    live_rank = torch.cumsum(live.to(torch.int32), 0)
    n_live = live_rank[-1] if n else torch.zeros((), dtype=torch.int32)
    dead_rank = torch.cumsum((~live).to(torch.int32), 0)
    dest = torch.where(live, live_rank - 1, n_live + dead_rank - 1).long()
    src = torch.empty_like(dest)
    src[dest] = torch.arange(n, device=live.device)
    for name in LANE_NAMES:
        t = getattr(sp, name)
        t.copy_(t[src])
    for t in extra:
        t.copy_(t[..., src])
    return sp.replace(np=n_live.to(torch.int32))


def _migrate_round(sp, pend, disp, acc, rhob, g: Grid, qsp: float,
                   mig_cap: int, max_streak: int, n_dropped, vbc, stats):
    """One communication round for one species, in place: pack the lanes
    parked at remote faces, exchange, compact, append the arrivals and walk
    them on.  ``disp`` is the (3, N) remaining displacement; returns
    (species, n_dropped)."""
    from .parallel.mesh import mesh_of
    faces = _remote_faces(g)
    if not faces:
        return sp, n_dropped
    m = mesh_of(g)
    me = flat_rank(g)
    tabs = halo_partners(g)
    N = sp.capacity
    dev = sp.dx.device
    # the movers, in slot order within each face (the JAX package's cumsum
    # ranking): one device read for their slots, one for their faces and
    # the live count left
    parked = sp.live & torch.isin(pend, torch.tensor(faces, device=dev))
    sel = torch.nonzero(parked).squeeze(1)
    face_of = pend[sel]
    order = torch.argsort(face_of, stable=True)
    sel, face_of = sel[order], face_of[order]
    live = sp.live.clone()
    live[sel] = False
    pend[sel] = DONE
    host = torch.cat([face_of, live.sum(dtype=torch.int32)[None]]).tolist()
    m.host_syncs += 2
    counts = [host[:-1].count(f) for f in faces]
    n_live = host[-1]
    xi, yi, zi = decode_voxel(sp.i[sel], g)
    rows = torch.stack([sp.dx[sel], sp.dy[sel], sp.dz[sel], xi.float(),
                        yi.float(), zi.float(), sp.ux[sel], sp.uy[sel],
                        sp.uz[sel], sp.w[sel], disp[0][sel], disp[1][sel],
                        disp[2][sel]], dim=1)
    bufs, n_send, start = [], [], 0
    for c in counts:
        bufs.append(rows[start:start + min(c, mig_cap)])
        n_send.append(min(c, mig_cap))
        if c > mig_cap:
            # movers past the buffer: dropped with their charge into rhob
            ovf = torch.zeros(N, dtype=torch.bool, device=dev)
            ovf[sel[start + mig_cap:start + c]] = True
            deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w, qsp, ovf)
            n_dropped = n_dropped + (c - mig_cap)
        start += c
    sp.live.copy_(live)
    sp.w.masked_fill_(~live, 0.0)
    disp.masked_fill_(~live.unsqueeze(0), 0.0)
    dsts = [tabs[f][me] for f in faces]
    srcs = [next((r for r, p in enumerate(tabs[f]) if p == me), -1)
            for f in faces]
    n_recv = m.exchange_counts(n_send, dsts, srcs)
    recv = m.exchange_rows(bufs, n_send, n_recv, dsts, srcs)
    stats["migrated"] += sum(n_send)
    if not any(n_recv):
        return sp.replace(np=sp.live.sum(dtype=torch.int32)), n_dropped

    # free the holes (only when lanes arrive: the others may keep theirs,
    # every sort and push covers the capacity), then append the arrivals
    # after the live prefix
    compact(sp, pend, disp)
    cont = torch.zeros(N, dtype=torch.bool, device=dev)
    slot = n_live
    for f, buf in zip(faces, recv):
        n_r = buf.shape[0]
        n_ins = max(0, min(n_r, N - slot))
        if n_r > n_ins:
            n_dropped = n_dropped + (n_r - n_ins)
        if n_ins == 0:
            continue
        buf = buf[:n_ins]
        # exported through the partner's face (axis, s): enters on my
        # opposite side (boundary_p.cc:226 flip)
        axis, s = FACE_AXIS[f], FACE_SIDE[f]
        n_ax = (g.nx, g.ny, g.nz)[axis]
        pos = [buf[:, 0], buf[:, 1], buf[:, 2]]
        co = [buf[:, 3].to(torch.int32), buf[:, 4].to(torch.int32),
              buf[:, 5].to(torch.int32)]
        pos[axis] = -pos[axis]
        co[axis] = torch.full_like(co[axis], n_ax if s < 0 else 1)
        sl = slice(slot, slot + n_ins)
        sp.dx[sl] = pos[0]
        sp.dy[sl] = pos[1]
        sp.dz[sl] = pos[2]
        sp.i[sl] = co[0] + g.NX * (co[1] + g.NY * co[2])
        sp.ux[sl] = buf[:, 6]
        sp.uy[sl] = buf[:, 7]
        sp.uz[sl] = buf[:, 8]
        sp.w[sl] = buf[:, 9]
        sp.live[sl] = True
        disp[:, sl] = buf[:, 10:13].T
        pend[sl] = DONE
        cont[sl] = True
        slot += n_ins
    if slot == n_live:
        return sp.replace(np=sp.live.sum(dtype=torch.int32)), n_dropped
    # walk the arrivals' remaining displacement on (boundary_p.cc:440-494);
    # one that leaves again gets a fresh pend code
    sp, new_pend, new_disp, _, _ = MP.move_p(sp, pend, disp, acc, rhob, g,
                                            qsp, cont, max_streak, vbc=vbc)
    if new_pend is not pend:
        pend.copy_(new_pend)
    if isinstance(new_disp, tuple) and new_disp[0].data_ptr() != \
            disp[0].data_ptr():
        disp.copy_(torch.stack(new_disp))
    return sp, n_dropped


def boundary_p(species: Sequence[SpeciesState], sp_params, pends, disps,
               acc, rhob, g: Grid, num_comm_round: int = 0,
               max_streak: int = 4,
               custom_handlers: Optional[Dict[int, Callable]] = None,
               generator: Optional[torch.Generator] = None, diag=None,
               vbc=None, stats=None):
    """Process parked lanes for every species: the custom-BC handlers, then
    ``num_comm_round`` migration rounds (decomposed grids; on an
    undecomposed one they move nothing), each followed by the handlers
    again, then the leftover drop.

    ``pends`` holds one (N,) int32 pend array per species, ``disps`` one
    (dx, dy, dz) remaining displacement per species (a triple or a (3, N)
    tensor).  ``custom_handlers`` maps a registry key to a handler
      handler(generator, sp, pend, disp, acc, rhob, g, spp, key, diag)
        -> (sp, pend, disp, acc, rhob, diag)
    that consumes the live lanes with pend == CUSTOM_BASE + key (key % 6 is
    the geometric face) and draws its randoms from ``generator`` (a handler
    that draws, maxwellian_reflux, raises when it is None; the deck passes
    the Simulation's).  A pend code of a slot that is not live means
    nothing (the push kernels do not write them).  ``diag`` is
    the state's dict of named device tensors handlers count into; its keys
    are fixed at Simulation.initialize.  ``vbc`` is the per-voxel-face
    table the arrivals walk on with; each species' buffers hold
    max(64, capacity * MIG_FRAC) movers a face; ``stats`` (a dict) gets
    the count of lanes sent added to its "migrated".  Returns (species,
    acc, rhob, n_dropped, diag) with the species updated in place."""
    check_particle_bcs(g)
    species = list(species)
    handlers = custom_handlers or {}
    dev = rhob.device
    diag = {} if diag is None else diag
    stats = {"migrated": 0} if stats is None else stats
    stats.setdefault("migrated", 0)
    n_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    migrate = bool(_remote_faces(g))

    def run_handlers(sp, pend, disp, acc, rhob, diag, spp):
        for key, handler in handlers.items():
            sp, pend, disp, acc, rhob, diag = handler(
                generator, sp, pend, disp, acc, rhob, g, spp, key, diag)
        return sp, pend, disp, acc, rhob, diag

    for k, spp in enumerate(sp_params):
        sp, pend, disp = species[k], pends[k], disps[k]
        if not isinstance(disp, torch.Tensor):
            disp = torch.stack(tuple(disp))
        sp, pend, disp, acc, rhob, diag = run_handlers(
            sp, pend, disp, acc, rhob, diag, spp)
        if not isinstance(disp, torch.Tensor):
            disp = torch.stack(tuple(disp))
        mig_cap = max(64, int(sp.capacity * MIG_FRAC))
        for _ in range(num_comm_round):
            if migrate:
                pend = pend.contiguous()
                disp = disp.contiguous()
                sp, n_dropped = _migrate_round(
                    sp, pend, disp, acc, rhob, g, spp.q, mig_cap,
                    max_streak, n_dropped, vbc, stats)
            # handlers again for lanes the rounds parked anew
            sp, pend, disp, acc, rhob, diag = run_handlers(
                sp, pend, disp, acc, rhob, diag, spp)
            if not isinstance(disp, torch.Tensor):
                disp = torch.stack(tuple(disp))

        # Leftover pends: drop with charge -> rhob (advance.cc:78-101).
        leftover = (pend >= 0) & (pend != UNFINISHED) & (pend != DONE) \
            & sp.live
        rhob = deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w,
                            spp.q, leftover)
        live = sp.live & ~leftover
        n_dropped = n_dropped + leftover.sum(dtype=torch.int32)
        sp.w.copy_(torch.where(live, sp.w, 0.0))
        sp.live.copy_(live)
        species[k] = sp.replace(np=live.sum(dtype=torch.int32))
    return species, acc, rhob, n_dropped, diag
