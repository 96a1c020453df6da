"""Custom particle boundary conditions (counterpart of
``vpic_tpu/boundary_ops.py``, src/boundary/).

Each factory returns a handler with the boundary_p custom-BC protocol:
  handler(generator, sp, pend, disp, acc, rhob, g, spp, key, diag)
    -> (sp, pend, disp, acc, rhob, diag)
consuming the lanes parked with pend == CUSTOM_BASE + key (key % 6 is the
geometric exit face: 0-5 for domain faces, 6 + 6 h + face for region
surfaces; only live lanes: the push kernels leave the pend codes of dead
slots undefined) and, where the particle lives on, continuing its
remaining displacement through ``ops/move_p`` (the reference re-injects
through move_p, boundary_p.cc:440-494; on the card one kernel launch).  Handlers write the species' lane tensors
in place and never move or create a live slot (``in_place``), so the
kernels' extent sorts and the residency path stay valid.

Randoms come from the ``torch.Generator`` the Simulation owns; the JAX
package draws from ``jax.random`` keys, whose streams torch cannot
reproduce, so the two packages' reflux agrees in distribution only.

``diag`` is the state's dict of named device tensors: handlers that count
(absorb_tally, link_boundary) expose ``diag_init(sp_params, key, device)``
so Simulation.initialize can create their keys once, and accumulate into
them; read them back with ``tally_of`` / ``write_links``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .grid import FACE_AXIS, FACE_SIDE, Grid
from .ops.move_p import move_p
from .ops.push import CUSTOM_BASE, DONE, deposit_rhob

SQRT2 = math.sqrt(2.0)


def _kill(sp, mask):
    """Lanes under ``mask`` die in place (w = 0); np recounted."""
    live = sp.live & ~mask
    sp.w.copy_(torch.where(live, sp.w, 0.0))
    sp.live.copy_(live)
    return sp.replace(np=live.sum(dtype=torch.int32))


def maxwellian_reflux(ut_para: Dict[str, float], ut_perp: Dict[str, float]):
    """maxwellian_reflux (maxwellian_reflux.c:40-241): absorbed particles
    are re-emitted with flux-weighted parallel momentum
    (u_par = sqrt(2) ut sqrt(-log U), the half-Maxwellian flux CDF inverse)
    and bi-Maxwellian perpendicular momentum; the remaining displacement is
    rescaled to keep the particle's fractional age.  Draws, in the JAX
    package's order: the exit speed, then the two perpendicular normals."""

    def handler(gen, sp, pend, disp, acc, rhob, g: Grid, spp, key,
                diag=None):
        if gen is None:
            raise ValueError("maxwellian_reflux draws randoms: pass the "
                             "Simulation's torch.Generator")
        mask = (pend == CUSTOM_BASE + key) & sp.live
        axis = FACE_AXIS[key % 6]
        side = FACE_SIDE[key % 6]
        utp = float(ut_para[spp.name])
        utq = float(ut_perp[spp.name])
        N = sp.capacity
        dev = sp.dx.device

        # flux-weighted parallel (into the domain) + thermal perpendicular
        uni = torch.rand(N, generator=gen, device=dev)
        e = -torch.log(torch.clamp(uni, min=1e-37))
        u_par = utp * SQRT2 * torch.sqrt(e) * (1.0 if side < 0 else -1.0)
        u_p1 = utq * torch.randn(N, generator=gen, device=dev)
        u_p2 = utq * torch.randn(N, generator=gen, device=dev)
        us = [None, None, None]
        us[axis] = u_par
        us[(axis + 1) % 3] = u_p1
        us[(axis + 2) % 3] = u_p2

        # rescale the remaining displacement to keep the fractional age
        # (maxwellian_reflux.c:127-155)
        dpx, dpy, dpz = disp
        ddx, ddy, ddz = g.dx * dpx, g.dy * dpy, g.dz * dpz
        u2_old = sp.ux ** 2 + sp.uy ** 2 + sp.uz ** 2
        u2_new = us[0] ** 2 + us[1] ** 2 + us[2] ** 2
        ratio = torch.sqrt(((1.0 + u2_old)
                            * (ddx * ddx + ddy * ddy + ddz * ddz))
                           / ((1.0 + u2_new)
                              * torch.clamp(u2_old, min=1e-37)))
        ndx = us[0] * ratio * g.rdx
        ndy = us[1] * ratio * g.rdy
        ndz = us[2] * ratio * g.rdz

        for name, new in zip(("ux", "uy", "uz"), us):
            t = getattr(sp, name)
            t.copy_(torch.where(mask, new, t))
        disp = (torch.where(mask, ndx, dpx), torch.where(mask, ndy, dpy),
                torch.where(mask, ndz, dpz))
        pend = torch.where(mask, DONE, pend)
        out = move_p(sp, pend, disp, acc, rhob, g, spp.q, mask)
        return out + (diag,)

    handler.in_place = True
    return handler


def _tally_key(name: str, key: int) -> str:
    return f"absorb_tally/{name}/f{key}"


def absorb_tally():
    """absorb_tally (absorb_tally.c:12-84): absorb the particle, add its
    charge to rhob (corrected trilinear) and count it under the diag key
    ``absorb_tally/{name}/f{key}`` (made by ``handler.diag_init``); read it
    back on the host with ``tally_of(state.diag, name, key)``."""

    def handler(gen, sp, pend, disp, acc, rhob, g: Grid, spp, key,
                diag=None):
        mask = (pend == CUSTOM_BASE + key) & sp.live
        rhob = deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w,
                            spp.q, mask)
        sp = _kill(sp, mask)
        pend = torch.where(mask, DONE, pend)
        k = _tally_key(spp.name, key)
        if diag is not None and k in diag:
            diag = {**diag, k: diag[k] + mask.sum(dtype=torch.int32)}
        return sp, pend, disp, acc, rhob, diag

    def diag_init(sp_params, key, device="cpu"):
        return {_tally_key(spp.name, key):
                torch.zeros((), dtype=torch.int32, device=device)
                for spp in sp_params}

    handler.diag_init = diag_init
    handler.in_place = True
    return handler


def tally_of(diag, species_name: str, key: int) -> int:
    """The absorb_tally count of (species, key) (a host read)."""
    v = diag[_tally_key(species_name, key)]
    return int(v.sum()) if isinstance(v, torch.Tensor) \
        else int(np.asarray(v).sum())


def link_boundary(prefix: str = "link", buffer_size: int = 4096):
    """link_boundary (src/boundary/link.c:18-74): an absorbing BC that logs
    the absorbed particles.  On the device it acts like absorb_tally; the
    records go to a fixed-size buffer in ``diag`` (keys
    ``link/{prefix}/{name}/f{key}/{n,buf,vox}``), and
    ``handler.write_links(state.diag)`` appends them to ``{prefix}.{rank}``
    on the host and returns the diag with the counters reset.  Records past
    ``buffer_size`` between writes are counted but not kept."""
    B = int(buffer_size)
    tag = f"link/{prefix}/"

    def _k(name, key, leaf):
        return f"{tag}{name}/f{key}/{leaf}"

    def handler(gen, sp, pend, disp, acc, rhob, g: Grid, spp, key,
                diag=None):
        mask = (pend == CUSTOM_BASE + key) & sp.live
        rhob = deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w,
                            spp.q, mask)
        kn = _k(spp.name, key, "n")
        if diag is not None and kn in diag:
            n0 = diag[kn]
            pos = n0 + torch.cumsum(mask.to(torch.int32), 0) - 1
            tgt = torch.where(mask & (pos < B), pos, B).long()
            rows = torch.stack([sp.dx, sp.dy, sp.dz, sp.ux, sp.uy, sp.uz,
                                sp.w], dim=1)
            kb, kv = _k(spp.name, key, "buf"), _k(spp.name, key, "vox")
            # row B takes every lane not kept and is cut off
            buf = torch.cat([diag[kb], diag[kb].new_zeros((1, 7))])
            vox = torch.cat([diag[kv], diag[kv].new_zeros((1,))])
            buf[tgt] = rows
            vox[tgt] = sp.i
            diag = {**diag, kn: n0 + mask.sum(dtype=torch.int32),
                    kb: buf[:B], kv: vox[:B]}
        sp = _kill(sp, mask)
        pend = torch.where(mask, DONE, pend)
        return sp, pend, disp, acc, rhob, diag

    def diag_init(sp_params, key, device="cpu"):
        d = {}
        for spp in sp_params:
            d[_k(spp.name, key, "n")] = torch.zeros((), dtype=torch.int32,
                                                    device=device)
            d[_k(spp.name, key, "buf")] = torch.zeros(
                (B, 7), dtype=torch.float32, device=device)
            d[_k(spp.name, key, "vox")] = torch.zeros(
                (B,), dtype=torch.int32, device=device)
        return d

    def write_links(diag, rank: int = 0):
        """Append the buffered records ('name key vox dx dy dz ux uy uz w'
        lines, the link.c file-per-rank analogue) and return the diag with
        the counters zeroed."""
        out = dict(diag)
        with open(f"{prefix}.{rank}", "a") as fh:
            for key in sorted(diag):
                if not (key.startswith(tag) and key.endswith("/n")):
                    continue
                base = key[:-2]
                name, facestr = base[len(tag):].split("/")
                n = int(diag[key])
                buf = diag[base + "/buf"].cpu().numpy()
                vox = diag[base + "/vox"].cpu().numpy()
                for r in range(min(n, B)):
                    fh.write(f"{name} {facestr[1:]} {vox[r]} "
                             + " ".join(repr(float(v)) for v in buf[r])
                             + "\n")
                out[key] = torch.zeros_like(diag[key])
        return out

    handler.diag_init = diag_init
    handler.write_links = write_links
    handler.in_place = True
    return handler
