"""1-D two-stream instability deck (counterpart of
``vpic_tpu/models/twostream.py``).

Two symmetric counter-streaming cold-ish electron beams over a neutralizing
immobile ion background in a periodic nx x 1 x 1 box.  The electrostatic
two-stream instability pumps beam kinetic energy into longitudinal E-field
energy, growing out of shot noise at rate ~ wpe/2 until trapping saturates
it: field growth by orders of magnitude with total energy conserved is the
oracle (tests/test_twostream.py).  A 2-D deck with ny = nz = 1: it runs
the 2-D push kernel and field_beb on one-cell y and z axes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..deck import Simulation


@dataclass
class TwoStreamParams:
    seed: int = 0
    nx: int = 64
    Lx: float = 2.0 * math.pi * 3.0   # ~3 fastest-growing wavelengths
    nppc: float = 64.0                # per beam
    v0: float = 0.2                   # beam drift (momentum/mc)
    vth: float = 0.005                # beam thermal spread
    mi_me: float = 1836.0
    cfl_req: float = 0.98
    wpedt_max: float = 0.2
    sort_interval: int = 25


def build(p: TwoStreamParams = TwoStreamParams(), device="cuda") -> Simulation:
    """The two-stream deck on ``device`` (the card unless the caller asks
    for the CPU)."""
    sim = Simulation(seed=p.seed, device=device)
    sim.seed_entropy(p.seed)
    ec, me, c, eps0 = 1.0, 1.0, 1.0, 1.0
    n0 = 1.0
    wpe = math.sqrt(n0 * ec * ec / (me * eps0))

    # transverse box: one cell, same physical size as a longitudinal cell
    dx = p.Lx / p.nx
    Ly = Lz = dx

    sim.define_units(c, eps0)
    dg = sim.courant_length(p.Lx, Ly, Lz, p.nx, 1, 1)
    dt = min(p.cfl_req * dg / c, p.wpedt_max / wpe)
    sim.define_timestep(dt)
    sim.define_periodic_grid((0, 0, 0), (p.Lx, Ly, Lz), (p.nx, 1, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.clean_div_e_interval = 50
    sim.clean_div_b_interval = 50
    sim.sync_shared_interval = 50

    Ne = int(p.nppc * p.nx)          # per beam
    vol = p.Lx * Ly * Lz
    we = 0.5 * n0 * vol / Ne         # each beam carries half the density

    electron = sim.define_species("electron", -ec, me, 2.4 * Ne, -1,
                                  p.sort_interval, 1)
    ion = sim.define_species("ion", ec, me * p.mi_me, 2.4 * Ne, -1,
                             4 * p.sort_interval, 1)

    rng = sim.rng(0)
    for sgn in (1.0, -1.0):
        xs = rng.uniform(0, p.Lx, Ne)
        ys = rng.uniform(0, Ly, Ne)
        zs = rng.uniform(0, Lz, Ne)
        ux = rng.normal(sgn * p.v0, p.vth, Ne)
        for k in range(Ne):
            sim.inject_particle(electron, xs[k], ys[k], zs[k],
                                ux[k], 0.0, 0.0, we)
        # cold stationary ions carry the neutralizing charge
        xi = rng.uniform(0, p.Lx, Ne)
        yi = rng.uniform(0, Ly, Ne)
        zi = rng.uniform(0, Lz, Ne)
        for k in range(Ne):
            sim.inject_particle(ion, xi[k], yi[k], zi[k], 0.0, 0.0, 0.0, we)

    sim.meta = dict(wpe=wpe, dt=dt, Ne=Ne, we=we, v0=p.v0)
    return sim
