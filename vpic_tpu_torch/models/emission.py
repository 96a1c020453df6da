"""Vacuum-diode deck (counterpart of ``vpic_tpu/models/emission.py``;
sample/emission analogue): a biased planar diode whose cathode emits
electrons by space-charge-limited (Child law) surface emission,
accelerating them across the gap to an absorbing anode.

define_surface_emitter(child_langmuir) (child_langmuir.c:8-211) on the
cathode surface and absorb_tally bookkeeping at the anode wall (a custom
face: the 2-D push kernel's WALLS instance parks the lanes that reach it
for boundary_p).  Oracle: emission turns on, a current crosses the gap,
and the anode tally grows once the transit time has passed.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import boundary_ops as BO
from .. import emitter as E
from ..deck import Simulation
from ..grid import BOUNDARY, PEC, REFLECT_PARTICLES


@dataclass
class EmissionParams:
    seed: int = 0
    nx: int = 32
    ny: int = 8
    Lx: float = 1.0
    Ly: float = 0.25
    bias_e: float = 0.5       # uniform accelerating field (+x)
    n_emit_per_face: int = 2
    ut_para: float = 0.02
    ut_perp: float = 0.01
    capacity: int = 65536
    cfl_req: float = 0.98
    topology: tuple = (1, 1, 1)


def build(p: EmissionParams = EmissionParams(), device="cuda") -> Simulation:
    """The diode on ``device`` (the card unless the caller asks for the
    CPU)."""
    sim = Simulation(seed=p.seed, device=device)
    c, eps0 = 1.0, 1.0
    sim.define_units(c, eps0)
    dz = p.Ly / p.ny
    dt = p.cfl_req * sim.courant_length(p.Lx, p.Ly, dz, p.nx, p.ny, 1) / c
    sim.define_timestep(dt)
    sim.define_periodic_grid((0, 0, 0), (p.Lx, p.Ly, dz),
                             (p.nx, p.ny, 1), p.topology)
    # cathode wall at -x (PEC, reflecting), anode at +x (PEC, absorbing
    # with a tally so the deck can read the collected current)
    sim.set_domain_field_bc(BOUNDARY(-1, 0, 0), PEC)
    sim.set_domain_field_bc(BOUNDARY(1, 0, 0), PEC)
    sim.set_domain_particle_bc(BOUNDARY(-1, 0, 0), REFLECT_PARTICLES)
    tally = BO.absorb_tally()
    sim.set_domain_particle_bc(BOUNDARY(1, 0, 0), tally)

    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    electron = sim.define_species("electron", -1.0, 1.0, p.capacity,
                                  -1, 20, 1)
    # a field pointing -x pulls the electrons (q < 0) to the anode
    sim.set_region_field(lambda x, y, z: True, ex=-abs(p.bias_e))

    # emit from the cathode-adjacent layer's low-x surface
    gap = p.Lx / p.nx
    region = lambda x, y, z: x > 1.5 * gap
    sim.define_surface_emitter(E.child_langmuir, region, electron,
                               n_emit_per_face=p.n_emit_per_face,
                               ut_para=p.ut_para, ut_perp=p.ut_perp,
                               thresh_e_norm=1e-6)
    sim.meta = dict(dt=dt, tally=tally)
    return sim
