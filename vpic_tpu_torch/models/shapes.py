"""Materials/regions demo deck (counterpart of
``vpic_tpu/models/shapes.py``, the sample/shapes analogue): a vacuum box
containing a dielectric slab (eps=4) and a conducting block (finite sigma),
placed with set_region_material, with a plane-wave pulse launched at them.

Oracle: the pulse slows inside the dielectric (phase velocity c/2) and
decays inside the conductor; total energy is non-increasing once the pulse
is inside the lossy block.  No particles: the step is the field advance
with mesh coefficients (the plain trio; ops/field_fuse refuses them).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..deck import Simulation, everywhere


@dataclass
class ShapesParams:
    seed: int = 0
    nx: int = 64
    ny: int = 16
    Lx: float = 16.0
    Ly: float = 4.0
    eps_slab: float = 4.0
    sigma_block: float = 2.0
    pulse_x0: float = 2.0
    pulse_w: float = 0.75
    cfl_req: float = 0.7      # dielectric slows the wave; keep margin
    topology: tuple = (1, 1, 1)


def build(p: ShapesParams = ShapesParams(), device="cuda") -> Simulation:
    """The shapes deck on ``device`` (the card unless the caller asks for
    the CPU)."""
    sim = Simulation(seed=p.seed, device=device)
    c, eps0 = 1.0, 1.0
    sim.define_units(c, eps0)
    dz = p.Ly / p.ny
    dt = p.cfl_req * sim.courant_length(p.Lx, p.Ly, dz, p.nx, p.ny, 1) / c
    sim.define_timestep(dt)
    sim.define_periodic_grid((0, 0, 0), (p.Lx, p.Ly, dz),
                             (p.nx, p.ny, 1), p.topology)

    sim.define_material("vacuum", 1.0)
    slab = sim.define_material("dielectric", eps=p.eps_slab)
    block = sim.define_material("conductor", eps=1.0, sigma=p.sigma_block)
    sim.define_field_array(damp=0.0)

    # dielectric slab across the middle third, conductor block near +x end
    x_s0, x_s1 = p.Lx * 0.375, p.Lx * 0.625
    x_b0 = p.Lx * 0.8
    sim.set_region_material(lambda x, y, z: x_s0 <= x < x_s1, slab)
    sim.set_region_material(lambda x, y, z: x >= x_b0, block)

    # rightward gaussian pulse (ey = bz -> +x propagation in vacuum)
    def pulse(x, y, z):
        return math.exp(-((x - p.pulse_x0) / p.pulse_w) ** 2)

    sim.set_region_field(everywhere, ey=pulse, bz=pulse)
    sim.meta = dict(dt=dt, x_slab=(x_s0, x_s1), x_block=x_b0)
    return sim
