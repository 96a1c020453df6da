"""Field diagnostics beyond energies (counterpart of
``vpic_tpu/diagnostics.py``): the Poynting flux
(src/vpic/diagnostics.cc:24-81) and the Gauss-law / div-B residuals the
regression decks use.  Each returns a 0-d float32 tensor on the state's
device and leaves the state as it was: the scratch meshes it fills
(rhof, div_e_err, div_b_err) are copies."""

from __future__ import annotations

import torch

from .grid import Grid, flat_rank, rank_coords
from .ops import fields as F
from .ops import push as P
from .state import FieldState


def poynting_flux(f: FieldState, g: Grid, e0: float = 1.0):
    """Average Poynting flux through the low-x boundary plane
    (diagnostics.cc:34-81): (ey*<cbz> - ez*<cby>) / (cvac^2 e0^2) sampled
    one x-plane inside the low-x face, summed over the reference's j,k in
    [1, n) transverse range and normalized by the sample count.
    Degenerate transverse axes (ny==1 or nz==1, where the reference's
    (n-1)-point range is empty and its normalization divides by zero) fall
    back to the single interior sample on that axis.  On a decomposed
    grid only the ranks on the global low-x face (ix == 0, the reference's
    RANK_TO_INDEX gate, diagnostics.cc:50-51) contribute, and the sum over
    ranks is normalized by the global sample count (:75)."""
    ys = slice(2, g.ny + 1) if g.ny > 1 else slice(1, 2)
    zs = slice(2, g.nz + 1) if g.nz > 1 else slice(1, 2)
    ey = f.ey[zs, ys, 2]
    ez = f.ez[zs, ys, 2]
    cbz = 0.5 * (f.cbz[zs, ys, 1] + f.cbz[zs, ys, 2])
    cby = 0.5 * (f.cby[zs, ys, 1] + f.cby[zs, ys, 2])
    s = ey * cbz - ez * cby
    local = torch.sum(s) / (g.cvac * g.cvac * e0 * e0)
    if g.sharded and rank_coords(g, flat_rank(g))[0] != 0:
        local = torch.zeros_like(local)
    ny_eff = (g.ny - 1) if g.ny > 1 else 1
    nz_eff = (g.nz - 1) if g.nz > 1 else 1
    return F.all_sum(local, g) / (ny_eff * nz_eff
                                  * g.topology[1] * g.topology[2])


def gauss_error(sim, state):
    """RMS Gauss-law residual of the current state (the energy_comparison
    regression's auxiliary check)."""
    g = sim.grid
    m = sim._material_coeffs()
    # compute_div_e_err fills the normal E and tca ghosts, synchronize_rho
    # adjusts rhob: it works on copies of every mesh it writes
    f = state.fields
    f = f.replace(**{n: getattr(f, n).clone()
                     for n in ("ex", "ey", "ez", "tcax", "tcay", "tcaz",
                               "rhob", "div_e_err")},
                  rhof=torch.zeros_like(f.rhof))
    rhof = f.rhof.view(-1)
    for st, sp in zip(sim.species, state.species):
        P.accumulate_rho_p(rhof, sp, g, st.params.q)
    F.synchronize_rho(f, g)
    F.compute_div_e_err(f, g, m)
    num, den = F.compute_rms_div_e_err(f, g)
    return g.eps0 * torch.sqrt(F.all_sum(num, g) / (den * g.n_shards))


def div_b_error(f: FieldState, g: Grid):
    """RMS div-B residual over the interior cells."""
    f = f.replace(div_b_err=f.div_b_err.clone())
    F.compute_div_b_err(f, g)
    num, den = F.compute_rms_div_b_err(f, g)
    return g.eps0 * torch.sqrt(F.all_sum(num, g) / (den * g.n_shards))
