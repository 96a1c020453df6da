"""SC08 one-triblade demo deck (counterpart of ``vpic_tpu/models/sc08.py``;
the reference's sample/SC08_ONE_TRIBLADE_DEMO, the Gordon Bell demo
configuration).

A 3-D Harris current sheet in x (B = b0 tanh(x/L) rotated by theta about
x), PEC field walls and reflecting particle walls at +-x, periodic y and z,
and two populations per species (drifting sheet + Maxwellian background)
with per-population macro weights.  The reference demo ran 150 x 25 x 100
cells at 1 ppc on a (1, 1, 4) decomposition; the defaults here are a
test-scale version of the same physics.  Neither grid is tiled by the 8^3
bricks: the deck takes the general path (the 3-D push kernel without home
maps), on one domain or decomposed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .. import deck as D
from ..grid import BOUNDARY, PEC, REFLECT_PARTICLES


@dataclass
class SC08Params:
    # physics (SC08:40-56)
    mi_me: float = 1.0
    rhoi_L: float = 1.0 / math.sqrt(2.0)
    Ti_Te: float = 1.0
    Tb_Te: float = 1.0
    nb_n0: float = 0.3
    wpe_wce: float = 4.0
    theta: float = math.pi / 2.0
    # numerics (reference: nx,ny,nz = 150,25,100; nppc 1)
    nx: int = 32
    ny: int = 8
    nz: int = 16
    nppc: float = 4.0
    cfl_req: float = 0.99
    wpedt_max: float = 0.36
    damp: float = 0.0
    num_step: int = 10
    topology: Tuple[int, int, int] = (1, 1, 1)   # demo ran (1, 1, 4)
    seed: int = 13


def build(p: SC08Params = SC08Params(), device="cuda") -> D.Simulation:
    """The SC08 deck on ``device`` (the card unless the caller asks for
    the CPU)."""
    c, ec, me, eps0 = 1.0, 1.0, 1.0, 1.0
    mi = me * p.mi_me
    L = 1.0    # sheet thickness sets the length unit via rhoi_L below

    Te = me * c * c / (2 * eps0 * p.wpe_wce ** 2 * (1 + p.Ti_Te))
    Ti = Te * p.Ti_Te
    Tb = Te * p.Tb_Te
    vthi = math.sqrt(Ti / mi)
    wci = vthi / (p.rhoi_L * L)
    wce = wci * p.mi_me
    wpe = wce * p.wpe_wce
    wpi = wpe / math.sqrt(p.mi_me)
    di = c / wpi
    cs, sn = math.cos(p.theta), math.sin(p.theta)

    Lx = 30 * di * p.nx / 150.0     # keep the reference's cells-per-di
    Ly = 30 * di / 6.0 * p.ny / 25.0
    Lz = 20 * di * p.nz / 100.0

    b0 = me * c * wce / ec
    n0 = me * eps0 * wpe * wpe / (ec * ec)
    vdre = b0 / (L * ec * n0 * (1 + p.Ti_Te))
    vdri = -p.Ti_Te * vdre
    tanhf = math.tanh(0.5 * Lx / L)
    Npe_sheet = 2 * n0 * Ly * Lz * L * tanhf
    Npe_back = p.nb_n0 * n0 * Ly * Lz * Lx
    Ne = p.nppc * p.nx * p.ny * p.nz
    Ne_sheet = int(Ne * Npe_sheet / (Npe_sheet + Npe_back))
    Ne_back = int(Ne * Npe_back / (Npe_sheet + Npe_back))
    w_s = Npe_sheet / max(Ne_sheet, 1)
    w_b = Npe_back / max(Ne_back, 1)
    gdre = 1 / math.sqrt(1 - vdre * vdre)
    gdri = 1 / math.sqrt(1 - vdri * vdri)
    udre = vdre * gdre
    udri = vdri * gdri
    uthe = math.sqrt(Te / me) / c
    uthi = math.sqrt(Ti / mi) / c
    utheb = math.sqrt(Tb / me) / c
    uthib = math.sqrt(Tb / mi) / c

    sim = D.Simulation(seed=p.seed, device=device)
    sim.define_units(c, eps0)
    g0 = D.partition_periodic_box(-0.5 * Lx, 0, 0, 0.5 * Lx, Ly, Lz,
                                  p.nx, p.ny, p.nz)
    dt = p.cfl_req * g0.courant_length() / c
    if wpe * dt > p.wpedt_max:
        dt = p.wpedt_max / wpe
    sim.define_timestep(dt)
    sim.define_periodic_grid((-0.5 * Lx, 0, 0), (0.5 * Lx, Ly, Lz),
                             (p.nx, p.ny, p.nz), p.topology)
    sim.set_domain_field_bc(BOUNDARY(-1, 0, 0), PEC)
    sim.set_domain_field_bc(BOUNDARY(1, 0, 0), PEC)
    sim.set_domain_particle_bc(BOUNDARY(-1, 0, 0), REFLECT_PARTICLES)
    sim.set_domain_particle_bc(BOUNDARY(1, 0, 0), REFLECT_PARTICLES)

    sim.num_step = p.num_step
    sim.status_interval = 200
    sim.sync_shared_interval = 20
    sim.clean_div_e_interval = 20
    sim.clean_div_b_interval = 20

    nshard = int(np.prod(p.topology))
    ele = sim.define_species("ele", -ec, me, 2.0 * Ne / nshard,
                             -1, 20, 1)
    ion = sim.define_species("ion", ec, mi, 2.0 * Ne / nshard, -1, 20, 1)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=p.damp)

    sim.set_region_field(
        D.everywhere,
        by=lambda x, y, z: -sn * b0 * np.tanh(x / L),
        bz=lambda x, y, z: cs * b0 * np.tanh(x / L))

    rng = np.random.default_rng(p.seed)
    for _ in range(Ne_sheet):
        while True:
            x = L * math.atanh(rng.uniform(-1, 1) * tanhf)
            if -0.5 * Lx < x < 0.5 * Lx:
                break
        y = rng.uniform(0, Ly)
        z = rng.uniform(0, Lz)
        ux, uy, uz = rng.normal(0, uthe, 3)
        d0 = gdre * uy + math.sqrt(ux * ux + uy * uy + uz * uz + 1) * udre
        uy, uz = d0 * cs - uz * sn, d0 * sn + uz * cs
        sim.inject_particle(ele, x, y, z, ux, uy, uz, w=w_s)
        ux, uy, uz = rng.normal(0, uthi, 3)
        d0 = gdri * uy + math.sqrt(ux * ux + uy * uy + uz * uz + 1) * udri
        uy, uz = d0 * cs - uz * sn, d0 * sn + uz * cs
        sim.inject_particle(ion, x, y, z, ux, uy, uz, w=w_s)
    for _ in range(Ne_back):
        x = rng.uniform(-0.5 * Lx, 0.5 * Lx)
        y = rng.uniform(0, Ly)
        z = rng.uniform(0, Lz)
        sim.inject_particle(ele, x, y, z, *rng.normal(0, utheb, 3), w=w_b)
        sim.inject_particle(ion, x, y, z, *rng.normal(0, uthib, 3), w=w_b)

    sim.meta = dict(b0=b0, wci=wci, dt=dt, Ne=Ne_sheet + Ne_back,
                    v_A=(wci / wpi) / math.sqrt(p.nb_n0))
    return sim
