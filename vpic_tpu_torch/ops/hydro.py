"""Hydro (fluid-moment) accumulation (counterpart of
``vpic_tpu/ops/hydro.py``): accumulate_hydro_p
(src/species_advance/standard/hydro_p.c:27-166).

Per particle: half E kick + half Boris rotate to time-center the momentum,
then the trilinear node-centered deposit of the 14 moments
  [jx jy jz rho  px py pz ke  txx tyy tzz tyz tzx txy]
into a (nv, 14) array (hydro_t analogue, sf_interface.h:168-198).

The deposit is one ``index_add_`` of every lane's 8 node contributions
(weight x moment rows), as hydro_p.c writes them.  The JAX package's
cell-moment form (one row scatter per lane, then 8 shifted dense adds) is a
trick for the TPU's slow indexed ops; on the GPU the direct scatter is the
function itself.  The two sum in different orders, so they agree to float
rounding, not bit for bit.  This is PyTorch work on either device (the JAX
package runs it as XLA ops): no hand kernel.
"""

from __future__ import annotations

import torch

from ..grid import Grid
from ..state import SpeciesState
from . import interp as I
from .fields import _combine_shared, _sync_axes
from .push import _boris_rotate, _interp_fields

N_HYDRO = 14
HYDRO_NAMES = ("jx", "jy", "jz", "rho", "px", "py", "pz", "ke",
               "txx", "tyy", "tzz", "tyz", "tzx", "txy")


def accumulate_hydro_p(hydro, sp: SpeciesState, fcoef, g: Grid, qsp, msp):
    """Add one species' moments into ``hydro`` (nv, 14), in place; returns
    it.  Dead slots (``live`` False) add nothing."""
    c = g.cvac
    mspc = msp * c
    qdt_2mc = (qsp * g.dt) / (2.0 * mspc)
    qdt_4mc2 = qdt_2mc / (2.0 * c)

    i = sp.i.long()
    hax, hay, haz, cbx, cby, cbz = _interp_fields(fcoef[i], sp.dx, sp.dy,
                                                  sp.dz, qdt_2mc)
    ux = sp.ux + hax
    uy = sp.uy + hay
    uz = sp.uz + haz
    usq = ux * ux + uy * uy + uz * uz
    gam = torch.sqrt(1.0 + usq)
    ke_mc = usq * c / (gam + 1.0)          # c (gamma - 1), robust form
    vz_fac = c / gam
    # half Boris rotate; the reference's angle scalar is qdt_4mc2 * c/gamma,
    # which _boris_rotate produces from arg * rsqrt(1 + u^2) with arg below
    ux, uy, uz = _boris_rotate(ux, uy, uz, cbx, cby, cbz, qdt_4mc2 * c)
    vx, vy, vzv = ux * vz_fac, uy * vz_fac, uz * vz_fac

    w = torch.where(sp.live, sp.w, 0.0)
    px_, py_, pz_ = mspc * ux, mspc * uy, mspc * uz
    mom = torch.stack([qsp * vx, qsp * vy, qsp * vzv,
                       torch.full_like(vx, qsp),
                       px_, py_, pz_, mspc * ke_mc,
                       px_ * vx, py_ * vy, pz_ * vzv,
                       py_ * vzv, pz_ * vx, px_ * vy], dim=-1)  # (N, 14)

    # node (a, b, c) of the voxel, a/b/c = 0 the low side, 1 the high one,
    # weighs (1 +- dx)(1 +- dy)(1 +- dz) r8V w
    q = g.r8V * w
    wx = (1.0 - sp.dx, 1.0 + sp.dx)
    wy = (1.0 - sp.dy, 1.0 + sp.dy)
    wz = (1.0 - sp.dz, 1.0 + sp.dz)
    weights, nodes = [], []
    for cz in (0, 1):
        for b in (0, 1):
            for a in (0, 1):
                weights.append(q * (wx[a] * (wy[b] * wz[cz])))
                nodes.append(i + (a + g.NX * (b + g.NY * cz)))
    weights = torch.stack(weights, dim=1)                      # (N, 8)
    nodes = torch.stack(nodes, dim=1).reshape(-1)              # (N * 8,)
    vals = (weights[:, :, None] * mom[:, None, :]).reshape(-1, N_HYDRO)
    hydro.index_add_(0, nodes, vals)
    return hydro


def synchronize_hydro(hydro, g: Grid):
    """synchronize_hydro_array (hydro_array.c): sum the node moments on
    shared faces (periodic wrap, or across ranks) so diagnostics see total
    values; in place, returns ``hydro``."""
    h = hydro.view(g.NZ, g.NY, g.NX, N_HYDRO)
    for axis, cross in _sync_axes(g):
        _combine_shared(h, axis, g, cross, "sum")
    return hydro


def compute_hydro(sim, state, k: int):
    """Species ``k``'s synchronized node moments (nv, 14) of ``state``, on
    the state's device."""
    g = sim.grid
    spp = sim.species[k].params
    fcoef = I.load_interpolator(state.fields, g)
    hydro = torch.zeros((g.nv, N_HYDRO), dtype=torch.float32,
                        device=state.fields.ex.device)
    accumulate_hydro_p(hydro, state.species[k], fcoef, g, spp.q, spp.m)
    return synchronize_hydro(hydro, g)
