"""Simulation.make_multi_step on the port (vpic_tpu/deck.py:1563-1583's
n_sub steps in one call; here a loop of make_step()), on the CPU:
tests/test_boundary_emission.py:78-98's absorb_tally deck keeps its tally
across make_multi_step(12), and make_multi_step(n) equals n calls of
make_step() bit for bit (every field, lane, diag entry and the
generator's state) on a deterministic deck (harris) and on one that draws
from the Simulation's generator every step (the emission diode)."""

import numpy as np
import pytest
import torch

import vpic_tpu_torch as vt
from vpic_tpu_torch import boundary_ops as BO
from vpic_tpu_torch.interop import state_to_numpy
from vpic_tpu_torch.models import emission, harris

torch.set_num_threads(2)


def test_absorb_tally_survives_multi_step():
    sim = vt.Simulation(seed=0, device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (8, 8, 8))
    sim.set_domain_field_bc(vt.BOUNDARY(1, 0, 0), vt.ABSORB_FIELDS)
    sim.set_domain_particle_bc(vt.BOUNDARY(1, 0, 0), BO.absorb_tally())
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    spc = sim.define_species("beam", 1e-6, 1.0, 512, -1, 0, 1)
    u = 0.4 / np.sqrt(1 - 0.4 ** 2)
    n_inj = 30
    for k in range(n_inj):
        sim.inject_particle(spc, 0.9, (k % 7 + 0.5) / 8, (k % 5 + 0.5) / 8,
                            u, 0, 0, 1.0)
    state = sim.initialize()
    face = next(iter(sim.pbc_handlers))
    assert BO.tally_of(state.diag, "beam", face) == 0
    many = sim.make_multi_step(12)
    assert many.path == sim.make_step().path
    state = many(state)
    assert state.step == 12
    assert int(state.species[0].np) == 0
    assert BO.tally_of(state.diag, "beam", face) == n_inj


DECKS = {
    "harris": lambda: harris.build(harris.HarrisParams(
        nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0), device="cpu"),
    "emission": lambda: emission.build(emission.EmissionParams(
        nx=16, ny=4, Lx=0.5, Ly=0.125), device="cpu"),
}


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_multi_step_equals_single_steps(deck):
    n = 9
    runs = []
    for multi in (False, True):
        sim = DECKS[deck]()
        state = sim.initialize()
        if multi:
            state = sim.make_multi_step(n)(state)
        else:
            step = sim.make_step()
            for _ in range(n):
                state = step(state)
        runs.append((state_to_numpy(state), sim._generator.get_state()))
    (a, ga), (b, gb) = runs
    assert a["step"] == b["step"] == n and torch.equal(ga, gb)
    for k in a["fields"]:
        assert np.array_equal(a["fields"][k], b["fields"][k]), k
    for sa, sb in zip(a["species"], b["species"]):
        for k in sa:
            assert np.array_equal(sa[k], sb[k]), k
    assert a["diag"].keys() == b["diag"].keys()
    for k in a["diag"]:
        assert np.array_equal(a["diag"][k], b["diag"][k]), k
