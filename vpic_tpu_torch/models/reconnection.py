"""Collisional 3-D reconnection deck (counterpart of
``vpic_tpu/models/reconnection.py``; sample/reconnection/open-collisional
analogue): the Harris sheet deck in 3-D with three Takizuka-Abe operators
(ion-ion, electron-electron, electron-ion), every ``tau_coll_interval``
steps.  On a grid the 8^3 bricks tile it runs the 3-D residency path and
rebuckets before the push on the steps the operators fire."""

from __future__ import annotations

from dataclasses import dataclass

from .. import collision as C
from . import harris


@dataclass
class ReconnectionParams(harris.HarrisParams):
    nz: int = 8
    Lz: float = 4.0
    tau_coll_interval: int = 5      # collision op cadence (steps)
    log_lambda: float = 10.0
    coll_n0: float = 1.0            # density scale for the T&A variance


def build(p: ReconnectionParams = ReconnectionParams(),
          device="cuda") -> harris.Simulation:
    """The deck on ``device`` (the card unless the caller asks for the
    CPU)."""
    sim = harris.build(p, device=device)
    g = sim.grid
    ion, electron = sim.species[0].params, sim.species[1].params
    for (i, j, pi, pj) in ((0, 0, ion, ion), (1, 1, electron, electron),
                           (1, 0, electron, ion)):
        sim.collision_ops.append(C.make_takizuka_abe_op(
            i, j, pi, pj, g, log_lambda=p.log_lambda, n0=p.coll_n0,
            interval=p.tau_coll_interval))
    return sim
