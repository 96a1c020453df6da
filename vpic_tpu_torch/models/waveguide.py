"""Parallel-plate-waveguide deck (counterpart of
``vpic_tpu/models/waveguide.py``; sample/waveguide analogue): a guide along
x between PEC plates at y = 0 and y = Ly, driven at the x = 0 end with the
lowest TE mode (Ez ~ sin(pi y/Ly) sin(w t)) through the
user_field_injection hook, with an absorbing far end.

Ez is tangential to the plates (the n = 0 TEM mode, which has no cutoff,
cannot be excited) and the mode dispersion is w^2 = k^2 c^2 + (n pi c/Ly)^2.
Oracle: the cutoff w_c = pi c / Ly; drive above cutoff propagates down the
guide, below cutoff it is evanescent.  No species: the step is the plain
field trio with the hook between advance_e and the second advance_b.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..deck import Simulation
from ..grid import (ABSORB_FIELDS, ABSORB_PARTICLES, BOUNDARY,
                    PEC, REFLECT_PARTICLES)


@dataclass
class WaveguideParams:
    seed: int = 0
    nx: int = 96
    ny: int = 16
    Lx: float = 24.0
    Ly: float = 4.0
    omega: float = 1.5       # drive frequency; cutoff is pi/Ly ~ 0.785
    e0: float = 1.0
    ramp_periods: float = 1.0
    cfl_req: float = 0.98
    topology: tuple = (1, 1, 1)


def build(p: WaveguideParams = WaveguideParams(),
          device="cuda") -> Simulation:
    """The waveguide deck on ``device`` (the card unless the caller asks
    for the CPU)."""
    sim = Simulation(seed=p.seed, device=device)
    c, eps0 = 1.0, 1.0
    sim.define_units(c, eps0)
    dt = p.cfl_req * sim.courant_length(p.Lx, p.Ly, 1.0, p.nx, p.ny, 1) / c
    sim.define_timestep(dt)
    # PEC walls on x and y (z stays periodic: the guide is 2D, nz == 1 and
    # a PEC z-wall would zero the whole transverse field), then open the +x
    # far end into an absorber so the launched mode exits instead of standing.
    sim.define_periodic_grid((0, 0, 0), (p.Lx, p.Ly, p.Ly / p.ny),
                             (p.nx, p.ny, 1), p.topology)
    for face in (BOUNDARY(-1, 0, 0), BOUNDARY(0, -1, 0), BOUNDARY(0, 1, 0)):
        sim.set_domain_field_bc(face, PEC)
        sim.set_domain_particle_bc(face, REFLECT_PARTICLES)
    sim.set_domain_field_bc(BOUNDARY(1, 0, 0), ABSORB_FIELDS)
    sim.set_domain_particle_bc(BOUNDARY(1, 0, 0), ABSORB_PARTICLES)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)

    # TE1 transverse profile on the launch plane (Ez is node-centered in y:
    # real rows j = 1..ny+1 sit at y = (j-1) dy, zero at both plates).
    yprof = np.sin(math.pi * (np.arange(p.ny + 2) - 1) / p.ny)
    yprof[0] = 0.0
    yprof[p.ny + 1] = 0.0
    yprof32 = torch.from_numpy(yprof.astype(np.float32))
    on_device = {}
    ramp_steps = max(int(p.ramp_periods * 2 * math.pi / (p.omega * dt)), 1)
    f32 = np.float32

    def field_injection(f, step):
        t = f32(step) * f32(dt)
        # smooth (cosine) turn-on: an abrupt ramp injects broadband
        # transients that ring near-cutoff modes the ABC cannot absorb
        frac = np.minimum(f32(step) / f32(ramp_steps), f32(1.0))
        ramp = f32(0.5) * (f32(1.0) - np.cos(f32(math.pi) * frac))
        drive = f32(p.e0) * ramp * np.sin(f32(p.omega) * t)
        dev = f.ez.device
        if dev not in on_device:
            on_device[dev] = yprof32.to(dev)
        # drive one plane inside the PEC wall so local_adjust_tang_e
        # does not zero the source
        f.ez[:, :, 2] = on_device[dev] * float(drive)
        return f

    sim.user_field_injection = field_injection
    sim.meta = dict(dt=dt, omega=p.omega, cutoff=math.pi * c / p.Ly)
    return sim
