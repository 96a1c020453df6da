"""Radiating-dipole deck (counterpart of ``vpic_tpu/models/dipole.py``;
sample/dipole analogue): an oscillating current element at the box centre
drives outgoing EM radiation into absorbing (Higdon first-order) field
boundaries.  The oracles are outgoing radiation and bounded field energy
(the absorbers eat what the dipole radiates).

The drive is the user_current_injection hook (the reference's
begin_current_injection deck section), in float32 as the JAX deck
computes it.  No species: the step is the field advance, the plain field
trio (ops/field_fuse refuses absorbing faces).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..deck import Simulation
from ..grid import ABSORB_PARTICLES


@dataclass
class DipoleParams:
    seed: int = 0
    n: int = 32               # cells per axis (cubical box)
    L: float = 16.0
    omega: float = 2.0        # drive angular frequency
    j0: float = 1.0           # peak current density
    ramp_periods: float = 1.0
    cfl_req: float = 0.98
    topology: tuple = (1, 1, 1)


def build(p: DipoleParams = DipoleParams(), device="cuda") -> Simulation:
    """The dipole deck on ``device`` (the card unless the caller asks for
    the CPU)."""
    sim = Simulation(seed=p.seed, device=device)
    c, eps0 = 1.0, 1.0
    sim.define_units(c, eps0)
    dt = p.cfl_req * sim.courant_length(p.L, p.L, p.L, p.n, p.n, p.n) / c
    sim.define_timestep(dt)
    sim.define_absorbing_grid((0, 0, 0), (p.L, p.L, p.L), (p.n, p.n, p.n),
                              p.topology, pbc=ABSORB_PARTICLES)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)

    # z-directed dipole: drive jfz in the center cell every step.
    cx = p.n // 2 + 1
    ramp_steps = max(int(p.ramp_periods * 2 * math.pi / (p.omega * dt)), 1)
    f32 = np.float32

    def current_injection(f, step):
        t = f32(step) * f32(dt)
        ramp = np.minimum(f32(step) / f32(ramp_steps), f32(1.0))
        drive = f32(p.j0) * ramp * np.sin(f32(p.omega) * t)
        f.jfz[cx, cx, cx] += float(drive)
        return f

    sim.user_current_injection = current_injection
    sim.meta = dict(dt=dt, omega=p.omega, center=cx)
    return sim
