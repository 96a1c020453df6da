"""Beam-plasma (two-stream) instability deck (counterpart of
``vpic_tpu/models/beam_plas.py``; sample/beam_plas analogue).

A cold electron beam drifts through a stationary plasma in a periodic box;
the two-stream instability grows electrostatic waves that trap the beam.
Oracle: longitudinal field energy grows exponentially out of the beam
kinetic energy while total energy is conserved.  Three species on a 2-D
grid: the 2-D push kernel pushes them in one launch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..deck import Simulation


@dataclass
class BeamPlasParams:
    seed: int = 0
    nx: int = 64
    ny: int = 4
    nz: int = 1
    Lx: float = 32.0
    Ly: float = 2.0
    Lz: float = 1.0
    nppc: float = 64.0
    n_beam_over_n0: float = 0.1
    u_beam: float = 0.3          # beam drift momentum (gamma beta)
    uth_plasma: float = 0.01
    uth_beam: float = 0.005
    mi_me: float = 1836.0
    cfl_req: float = 0.99
    wpedt_max: float = 0.2
    topology: tuple = (1, 1, 1)
    sort_interval: int = 25


def build(p: BeamPlasParams = BeamPlasParams(), device="cuda") -> Simulation:
    """The beam-plasma deck on ``device`` (the card unless the caller asks
    for the CPU)."""
    sim = Simulation(seed=p.seed, device=device)
    sim.seed_entropy(p.seed)
    ec, me, c, eps0 = 1.0, 1.0, 1.0, 1.0
    n0 = 1.0
    wpe = math.sqrt(n0 * ec * ec / (me * eps0))

    sim.define_units(c, eps0)
    dg = sim.courant_length(p.Lx, p.Ly, p.Lz, p.nx, p.ny, p.nz)
    dt = min(p.cfl_req * dg / c, p.wpedt_max / wpe)
    sim.define_timestep(dt)
    sim.define_periodic_grid((0, 0, 0), (p.Lx, p.Ly, p.Lz),
                             (p.nx, p.ny, p.nz), p.topology)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.clean_div_e_interval = 25
    sim.clean_div_b_interval = 50
    sim.sync_shared_interval = 50

    n_cells = p.nx * p.ny * p.nz
    vol = p.Lx * p.Ly * p.Lz
    Np_pl = int(p.nppc * n_cells)
    Np_bm = max(int(p.nppc * n_cells * p.n_beam_over_n0), n_cells)
    w_pl = n0 * vol / Np_pl
    w_bm = n0 * p.n_beam_over_n0 * vol / Np_bm

    ns = p.topology[0] * p.topology[1] * p.topology[2]
    plasma = sim.define_species("plasma_e", -ec, me, 1.3 * Np_pl / ns, -1,
                                p.sort_interval, 1)
    beam = sim.define_species("beam_e", -ec, me, 1.3 * Np_bm / ns, -1,
                              p.sort_interval, 1)
    ion = sim.define_species("ion", ec, me * p.mi_me,
                             1.3 * (Np_pl + Np_bm) / ns, -1,
                             4 * p.sort_interval, 1)

    rng = sim.rng(0)

    def inject(sp, n, w, udrift, uth):
        xs = rng.uniform(0, p.Lx, n)
        ys = rng.uniform(0, p.Ly, n)
        zs = rng.uniform(0, p.Lz, n)
        ux = rng.normal(udrift, uth, n)
        uy = rng.normal(0, uth, n)
        uz = rng.normal(0, uth, n)
        for k in range(n):
            sim.inject_particle(sp, xs[k], ys[k], zs[k],
                                ux[k], uy[k], uz[k], w)

    inject(plasma, Np_pl, w_pl, 0.0, p.uth_plasma)
    inject(beam, Np_bm, w_bm, p.u_beam, p.uth_beam)
    # Neutralizing ions carry the summed charge of both electron species.
    n_ion = Np_pl
    w_ion = (n0 + n0 * p.n_beam_over_n0) * vol / n_ion
    inject(ion, n_ion, w_ion, 0.0, p.uth_plasma / math.sqrt(p.mi_me))

    sim.meta = dict(wpe=wpe, dt=dt, Np_pl=Np_pl, Np_bm=Np_bm)
    return sim
