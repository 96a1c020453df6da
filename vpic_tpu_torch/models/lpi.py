"""Laser-plasma interaction deck (counterpart of ``vpic_tpu/models/lpi.py``;
sample/lpi_2d_F6_test analogue).

A laser is injected at the low-x boundary through the user field-injection
hook (begin_field_injection analogue; lpi_2d_F6_test:922-965), propagates
through vacuum into a plasma slab, with absorbing field boundaries at +-x
and maxwellian_reflux particle re-emission at the walls (lpi deck:499).
At its defaults (128 x 32 cells, 16 ppc in the slab) it runs through the
2-D push kernel, with the walls' lanes handed to ``boundary.boundary_p``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .. import boundary_ops as BO
from ..deck import Simulation
from ..grid import ABSORB_FIELDS, BOUNDARY, flat_rank, rank_coords


@dataclass
class LPIParams:
    seed: int = 0
    nx: int = 128
    ny: int = 32
    nz: int = 1
    Lx: float = 32.0
    Ly: float = 8.0
    Lz: float = 1.0
    nppc: float = 16.0
    n_over_nc: float = 0.1       # plasma density / critical density
    slab_x0: float = 16.0        # plasma slab start
    laser_a0: float = 0.1        # normalized laser amplitude
    laser_w: float = 1.0         # laser frequency (units of wpe/sqrt(n/nc))
    uth_e: float = 0.02
    mi_me: float = 1836.0
    cfl_req: float = 0.98
    topology: tuple = (1, 1, 1)


def build(p: LPIParams = LPIParams(), device="cuda") -> Simulation:
    """The lpi deck on ``device`` (the card unless the caller asks for the
    CPU)."""
    sim = Simulation(seed=p.seed, device=device)
    sim.seed_entropy(p.seed)
    ec, me, c, eps0 = 1.0, 1.0, 1.0, 1.0

    sim.define_units(c, eps0)
    dg = sim.courant_length(p.Lx, p.Ly, p.Lz, p.nx, p.ny, p.nz)
    dt = p.cfl_req * dg / c
    sim.define_timestep(dt)
    sim.define_periodic_grid((0, 0, 0), (p.Lx, p.Ly, p.Lz),
                             (p.nx, p.ny, p.nz), p.topology)
    # Absorbing field walls + refluxing particle walls at +-x.
    sim.set_domain_field_bc(BOUNDARY(-1, 0, 0), ABSORB_FIELDS)
    sim.set_domain_field_bc(BOUNDARY(1, 0, 0), ABSORB_FIELDS)
    mr = BO.maxwellian_reflux({"electron": p.uth_e, "ion":
                               p.uth_e / math.sqrt(p.mi_me)},
                              {"electron": p.uth_e, "ion":
                               p.uth_e / math.sqrt(p.mi_me)})
    sim.set_domain_particle_bc(BOUNDARY(-1, 0, 0), mr)
    sim.set_domain_particle_bc(BOUNDARY(1, 0, 0), mr)

    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.001)
    sim.clean_div_e_interval = 50
    sim.clean_div_b_interval = 50
    sim.sync_shared_interval = 25

    # Plasma slab: n = n_over_nc * critical density (nc = me eps0 w^2/e^2).
    w_l = p.laser_w
    nc = me * eps0 * w_l * w_l / (ec * ec)
    n_pl = p.n_over_nc * nc
    slab_vol = (p.Lx - p.slab_x0) * p.Ly * p.Lz
    n_cells_slab = int(p.nx * (1 - p.slab_x0 / p.Lx)) * p.ny * p.nz
    Ne = int(p.nppc * n_cells_slab)
    we = n_pl * slab_vol / max(Ne, 1)

    # per-shard capacity, as the JAX deck sizes it (only the x-shards that
    # overlap the slab stage particles)
    nsx = p.topology[0]
    overlap = sum(1 for i in range(nsx)
                  if (i + 1) * p.Lx / nsx > p.slab_x0) or 1
    ns = overlap * p.topology[1] * p.topology[2]
    electron = sim.define_species("electron", -ec, me, 2.0 * Ne / ns, -1,
                                  20, 1)
    ion = sim.define_species("ion", ec, me * p.mi_me, 2.0 * Ne / ns, -1,
                             80, 1)

    rng = sim.rng(0)
    uthi = p.uth_e / math.sqrt(p.mi_me)
    for k in range(Ne):
        x = rng.uniform(p.slab_x0, p.Lx)
        y = rng.uniform(0, p.Ly)
        z = rng.uniform(0, p.Lz)
        sim.inject_particle(electron, x, y, z,
                            rng.normal(0, p.uth_e), rng.normal(0, p.uth_e),
                            rng.normal(0, p.uth_e), we)
        sim.inject_particle(ion, x, y, z,
                            rng.normal(0, uthi), rng.normal(0, uthi),
                            rng.normal(0, uthi), we)

    # Laser injection: drive Ey on the x=1 boundary plane each step with a
    # smooth turn-on ramp (begin_field_injection idiom), in float32 as the
    # JAX deck computes it.  Only a rank on the global x-lo face (ix == 0)
    # drives it: another rank's local x = 1 plane is interior.
    f32 = np.float32
    e0 = p.laser_a0 * me * c * w_l / ec
    ramp_steps = int(2 * math.pi / (w_l * dt))
    gx = sim.grid

    def field_injection(f, step):
        if gx.sharded and rank_coords(gx, flat_rank(gx))[0] != 0:
            return f
        t = f32(step) * f32(dt)
        ramp = np.minimum(f32(step) / f32(ramp_steps), f32(1.0))
        drive = f32(e0) * ramp * np.sin(f32(w_l) * t)
        f.ey[:, :, 1] = float(drive)
        return f

    sim.user_field_injection = field_injection
    sim.meta = dict(dt=dt, e0=e0, nc=nc, Ne=Ne, w_l=w_l)
    return sim
