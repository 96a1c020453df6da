"""Particle boundary interaction on one device (counterpart of
``vpic_tpu/boundary.py``, boundary_p.cc:36-518).

The push parks lanes that reach a custom particle BC with pend =
CUSTOM_BASE + face (``ops/push.py``) and their remaining displacement;
``boundary_p`` dispatches them to the deck's registered handlers
(``boundary_ops``: maxwellian_reflux, absorb_tally, link_boundary; the
particle_bc_t interact dispatch, boundary_p.cc:250-255), then drops the
lanes still parked with their charge into rhob (the reference's leftover
drop, advance.cc:78-101).

The JAX package's migration rounds (``_migrate_round``: pack, ppermute,
unpack and continue the walk of lanes that left through a remote face)
belong to decomposed runs: ``check_particle_bcs`` raises for those grids,
as ``ops/fields.py`` does for remote field faces.  On one device the
rounds move nothing, so only the handler runs that follow each of them
remain (``num_comm_round``).

Everything happens in place: the handlers and the leftover drop write the
species' lane tensors (the residency path keeps them as static buffers);
``np`` is recounted as a new 0-d tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from .grid import Grid
from .ops.push import DONE, UNFINISHED, check_particle_bcs, deposit_rhob
from .state import SpeciesState


def boundary_p(species: Sequence[SpeciesState], sp_params, pends, disps,
               acc, rhob, g: Grid, num_comm_round: int = 0,
               max_streak: int = 4,
               custom_handlers: Optional[Dict[int, Callable]] = None,
               generator: Optional[torch.Generator] = None, diag=None):
    """Process parked lanes for every species: the custom-BC handlers, once
    and again after each of ``num_comm_round`` (empty) migration rounds,
    then the leftover drop.

    ``pends`` holds one (N,) int32 pend array per species, ``disps`` one
    (dx, dy, dz) remaining displacement per species (a triple or a (3, N)
    tensor).  ``custom_handlers`` maps a registry key to a handler
      handler(generator, sp, pend, disp, acc, rhob, g, spp, key, diag)
        -> (sp, pend, disp, acc, rhob, diag)
    that consumes the live lanes with pend == CUSTOM_BASE + key (key % 6 is
    the geometric face) and draws its randoms from ``generator`` (a handler
    that draws, maxwellian_reflux, raises when it is None; the deck passes
    the Simulation's).  A pend code of a slot that is not live means
    nothing (the push kernels do not write them).  ``diag`` is
    the state's dict of named device tensors handlers count into; its keys
    are fixed at Simulation.initialize.  Returns (species, acc, rhob,
    n_dropped, diag) with the species updated in place."""
    check_particle_bcs(g)
    species = list(species)
    handlers = custom_handlers or {}
    dev = rhob.device
    diag = {} if diag is None else diag
    n_dropped = torch.zeros((), dtype=torch.int32, device=dev)

    def run_handlers(sp, pend, disp, acc, rhob, diag, spp):
        for key, handler in handlers.items():
            sp, pend, disp, acc, rhob, diag = handler(
                generator, sp, pend, disp, acc, rhob, g, spp, key, diag)
        return sp, pend, disp, acc, rhob, diag

    for k, spp in enumerate(sp_params):
        sp, pend, disp = species[k], pends[k], tuple(disps[k])
        sp, pend, disp, acc, rhob, diag = run_handlers(
            sp, pend, disp, acc, rhob, diag, spp)
        for _ in range(num_comm_round):
            # handlers again for lanes their continuation parked anew
            sp, pend, disp, acc, rhob, diag = run_handlers(
                sp, pend, disp, acc, rhob, diag, spp)

        # Leftover pends: drop with charge -> rhob (advance.cc:78-101).
        leftover = (pend >= 0) & (pend != UNFINISHED) & (pend != DONE) \
            & sp.live
        rhob = deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w,
                            spp.q, leftover)
        live = sp.live & ~leftover
        n_dropped = n_dropped + leftover.sum(dtype=torch.int32)
        sp.w.copy_(torch.where(live, sp.w, 0.0))
        sp.live.copy_(live)
        species[k] = sp.replace(np=live.sum(dtype=torch.int32))
    return species, acc, rhob, n_dropped, diag
