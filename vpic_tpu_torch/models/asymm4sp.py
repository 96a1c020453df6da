"""Asymmetric reconnection deck with 4 species (counterpart of
``vpic_tpu/models/asymm4sp.py``; the sample/reconnection/asymm4sp
capability: separate sheet and background populations on an asymmetric
current layer).

An asymmetric tangential layer
    Bz(x) = (B2 - B1)/2 + (B2 + B1)/2 * tanh(x/L)
(B -> -B1 on the left, +B2 on the right, B2 = Rb*B1) held in approximate
pressure balance by a sech^2 Harris sheet population carrying the current
plus an asymmetric background whose density profile absorbs the residual
magnetic-pressure difference:
    n_bg(x) (kTi + kTe) = Ptot - Bz(x)^2 / 2 - P_sheet(x).
Each population is its own ion/electron pair (4 species), PEC field and
reflecting particle walls at +-x.  A 2-D deck: the 2-D push kernel pushes
the four species in one launch."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..deck import Simulation, everywhere
from ..grid import BOUNDARY, PEC, REFLECT_PARTICLES

# numpy 2 names the trapezoid rule trapezoid; the same sum as trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


@dataclass
class Asymm4spParams:
    mass_ratio: float = 1.0
    seed: int = 0
    Rb: float = 0.5          # |B_right| / |B_left| asymmetry
    Ti_Te: float = 2.0
    wpe_wce: float = 2.0
    rhoi_L: float = 1.0
    Lx: float = 16.0
    Ly: float = 16.0
    Lz: float = 1.0
    nx: int = 64
    ny: int = 64
    nz: int = 1
    nppc_sheet: float = 32.0   # sheet pair macro particles / cell
    nppc_bg: float = 32.0      # background pair macro particles / cell
    cfl_req: float = 0.99
    wpedt_max: float = 0.36
    damp: float = 0.001
    topology: tuple = (1, 1, 1)
    sort_interval: int = 20
    headroom: float = 1.5


def build(p: Asymm4spParams = Asymm4spParams(), device="cuda") -> Simulation:
    """The asymm4sp deck on ``device`` (the card unless the caller asks for
    the CPU)."""
    sim = Simulation(seed=p.seed, device=device)
    sim.seed_entropy(p.seed)

    L = 1.0
    ec, me, c, eps0 = 1.0, 1.0, 1.0, 1.0
    mi = me * p.mass_ratio
    kTe = me * c * c / (2 * p.wpe_wce ** 2 * (1 + p.Ti_Te))
    kTi = kTe * p.Ti_Te
    vthi = math.sqrt(2 * kTi / mi)
    wci = vthi / (p.rhoi_L * L)
    wce = wci * p.mass_ratio
    wpe = wce * p.wpe_wce
    b1 = me * wce / ec                       # left asymptotic field
    b2 = p.Rb * b1
    n0 = me * eps0 * wpe * wpe / (ec * ec)   # sheet peak density

    # drift speeds carrying J = dBz/dx at the sheet (Harris partition)
    vdre = c * c * wce / (wpe * wpe * L * (1 + p.Ti_Te)) \
        * 0.5 * (1 + p.Rb)
    vdri = -p.Ti_Te * vdre

    def Bz(x):
        return (b2 - b1) / 2 + (b2 + b1) / 2 * math.tanh(x / L)

    # pressure balance: Ptot covers the larger magnetic pressure side
    Ptot = max(b1, b2) ** 2 / 2 + 0.1 * n0 * (kTi + kTe)

    def n_sheet(x):
        return n0 * (1.0 / math.cosh(x / L)) ** 2

    def n_bg(x):
        pb = Ptot - Bz(x) ** 2 / 2 - n_sheet(x) * (kTi + kTe)
        return max(pb, 0.0) / (kTi + kTe)

    sim.define_units(c, eps0)
    dg = sim.courant_length(p.Lx, p.Ly, p.Lz, p.nx, p.ny, p.nz)
    dt = min(p.cfl_req * dg / c, p.wpedt_max / wpe)
    sim.define_timestep(dt)
    status = max(1, int(1.0 / (wci * dt)))
    sim.status_interval = status
    sim.sync_shared_interval = status
    sim.clean_div_e_interval = status
    sim.clean_div_b_interval = status

    sim.define_periodic_grid((-0.5 * p.Lx, 0, 0),
                             (0.5 * p.Lx, p.Ly, p.Lz),
                             (p.nx, p.ny, p.nz), p.topology)
    sim.set_domain_field_bc(BOUNDARY(-1, 0, 0), PEC)
    sim.set_domain_field_bc(BOUNDARY(1, 0, 0), PEC)
    sim.set_domain_particle_bc(BOUNDARY(-1, 0, 0), REFLECT_PARTICLES)
    sim.set_domain_particle_bc(BOUNDARY(1, 0, 0), REFLECT_PARTICLES)

    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=p.damp)

    n_cells = p.nx * p.ny * p.nz
    Ns = int(0.5 * p.nppc_sheet * n_cells)
    Nb = int(0.5 * p.nppc_bg * n_cells)
    n_sh = p.topology[0] * p.topology[1] * p.topology[2]
    cap_s = p.headroom * Ns / n_sh
    cap_b = p.headroom * Nb / n_sh
    ion_s = sim.define_species("ion_sheet", ec, mi, cap_s, -1,
                               2 * p.sort_interval, 1)
    ele_s = sim.define_species("electron_sheet", -ec, me, cap_s, -1,
                               p.sort_interval, 1)
    ion_b = sim.define_species("ion_bg", ec, mi, cap_b, -1,
                               2 * p.sort_interval, 1)
    ele_b = sim.define_species("electron_bg", -ec, me, cap_b, -1,
                               p.sort_interval, 1)

    sim.set_region_field(everywhere, 0, 0, 0, 0, 0,
                         lambda x, y, z: Bz(x))

    rng = sim.rng(0)
    uthi = math.sqrt(kTi / mi) / c
    uthe = math.sqrt(kTe / me) / c
    x_lo, x_hi = -0.5 * p.Lx, 0.5 * p.Lx

    def sample_x(density, n, peak):
        """Rejection-sample x positions from a density profile."""
        out = np.empty(0)
        while out.size < n:
            cand = rng.uniform(x_lo, x_hi, 2 * n)
            keep = rng.uniform(0, peak, 2 * n) < np.vectorize(density)(cand)
            out = np.concatenate([out, cand[keep]])[:n]
        return out

    # sheet pairs: drifting maxwellians weighted by integral of n_sheet
    Npair_s = n0 * p.Ly * p.Lz * 2 * L * math.tanh(0.5 * p.Lx / L)
    ws = Npair_s / Ns
    gdre = 1 / math.sqrt(1 - (vdre / c) ** 2)
    gdri = 1 / math.sqrt(1 - (vdri / c) ** 2)
    xs = sample_x(n_sheet, Ns, n0)
    ys = rng.uniform(0, p.Ly, Ns)
    zs = rng.uniform(0, p.Lz, Ns)
    for k in range(Ns):
        uy_i = rng.normal(gdri * vdri, uthi)
        uy_e = rng.normal(gdre * vdre, uthe)
        sim.inject_particle(ion_s, xs[k], ys[k], zs[k],
                            rng.normal(0, uthi), uy_i,
                            rng.normal(0, uthi), ws)
        sim.inject_particle(ele_s, xs[k], ys[k], zs[k],
                            rng.normal(0, uthe), uy_e,
                            rng.normal(0, uthe), ws)

    # background pairs: asymmetric density, no drift
    nbg_peak = max(n_bg(x_lo), n_bg(x_hi)) + 1e-30
    # integral of n_bg for the pair weight (trapezoid rule)
    grid_x = np.linspace(x_lo, x_hi, 512)
    nb_prof = np.vectorize(n_bg)(grid_x)
    Npair_b = float(_trapezoid(nb_prof, grid_x)) * p.Ly * p.Lz
    wb = Npair_b / max(Nb, 1)
    xb = sample_x(n_bg, Nb, nbg_peak)
    yb = rng.uniform(0, p.Ly, Nb)
    zb = rng.uniform(0, p.Lz, Nb)
    for k in range(Nb):
        sim.inject_particle(ion_b, xb[k], yb[k], zb[k],
                            rng.normal(0, uthi), rng.normal(0, uthi),
                            rng.normal(0, uthi), wb)
        sim.inject_particle(ele_b, xb[k], yb[k], zb[k],
                            rng.normal(0, uthe), rng.normal(0, uthe),
                            rng.normal(0, uthe), wb)

    sim.meta = dict(b1=b1, b2=b2, n0=n0, wci=wci, dt=dt)
    return sim
