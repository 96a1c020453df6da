"""The emission deck and the particle-injection hook in the port's step, on
the CPU: the diode oracle of tests/test_sample_decks.py:68-79 (and the
anode's tally growing once the transit time has passed), the
runtime-injection hook oracle of
tests/test_inject_reconnection.py:12-45 with the port's hook signature,
and where the step runs the emitters: after the push's boundary handlers
on the kernel paths, before boundary_p on the general path
(vpic_tpu/deck.py:1420-1432, :1461-1467).  The emitters' randoms come from
the Simulation's generator, so a run follows its seed."""

import numpy as np
import pytest
import torch

import vpic_tpu_torch as vt
from vpic_tpu_torch import boundary_ops as BO
from vpic_tpu_torch import deck as D
from vpic_tpu_torch import emitter as E
from vpic_tpu_torch.models import emission

torch.set_num_threads(2)

SMALL = dict(nx=16, ny=4, Lx=0.5, Ly=0.125)


def test_emission_diode_current():
    sim = emission.build(emission.EmissionParams(**SMALL), device="cpu")
    state = sim.initialize()
    step = sim.make_step()
    assert step.path == "push2d"
    assert int(state.species[0].np) == 0
    for _ in range(8):
        state = step(state)
    assert int(state.species[0].np) > 0
    assert np.isfinite(sim.energies(state).numpy()).all()


def test_diode_fills_the_gap():
    """The cathode emits from step 0 (its 4 faces x 2 lanes the first
    step), the anode's absorb_tally stays 0 until the electrons have crossed
    the gap and grows after; no lane is lost (the live and tallied lanes
    never decrease)."""
    sim = emission.build(emission.EmissionParams(**SMALL), device="cpu")
    state = sim.initialize()
    step = sim.make_step()
    key = [k for k in state.diag if k.startswith("absorb_tally/")][0]
    n, tally = [], []
    for _ in range(40):
        state = step(state)
        n.append(int(state.species[0].np))
        tally.append(int(state.diag[key]))
    assert n[0] == 8 and all(b > a for a, b in zip(n[:15], n[1:16]))
    assert tally[10] == 0 and tally[-1] > tally[29] > 0
    kept = [a + b for a, b in zip(n, tally)]
    assert all(b >= a for a, b in zip(kept, kept[1:])) and kept[-1] >= 320
    assert int(state.species[0].live.sum()) == n[-1]
    assert int(state.diag["unfinished"]) == 0


def test_emission_follows_the_seed():
    runs = []
    for seed in (0, 0, 1):
        sim = emission.build(emission.EmissionParams(**SMALL, seed=seed),
                             device="cpu")
        state = sim.initialize()
        step = sim.make_step()
        for _ in range(4):
            state = step(state)
        runs.append(state.species[0].ux.clone())
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])


def _injection_deck(shape=(8, 8, 8)):
    sim = vt.Simulation(seed=0, device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), shape)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.define_species("e", -1e-6, 1.0, 2048, -1, 0, 1)
    return sim


def test_runtime_injection_hook():
    """user_particle_injection (begin_particle_injection analogue) injects
    a trickle each step through emitter.runtime_inject; the port's hook
    takes the generator where vpic_tpu's takes a key."""
    sim = _injection_deck()
    M = 4

    def injector(species, f, fcoef, acc, rhob, g, step, generator):
        dev = rhob.device
        r = lambda *s: torch.rand(s, generator=generator, device=dev)
        x, y, z = r(M), r(M), r(M)
        u = 0.1 * torch.randn((3, M), generator=generator, device=dev)
        sp, acc, rhob = E.runtime_inject(
            species[0], g, acc, rhob, x, y, z, u[0], u[1], u[2],
            torch.ones(M, device=dev), -1e-6, age=r(M), update_rhob=True)
        return [sp] + list(species[1:]), acc, rhob

    sim.user_particle_injection = injector
    state = sim.initialize()
    step = sim.make_step()
    assert step.path == "general"
    for _ in range(10):
        state = step(state)
    assert int(state.species[0].np) == 10 * M
    assert int(state.species[0].live.sum()) == 10 * M
    assert np.isfinite(sim.energies(state).numpy()).all()
    assert float(state.fields.rhob.abs().sum()) > 0


@pytest.mark.parametrize("shape,path,order", [
    ((8, 8, 8), "general", ["inject", "boundary_p"]),
    ((16, 8, 1), "push2d", ["boundary_p", "inject"])])
def test_emitters_run_where_the_step_runs_them(monkeypatch, shape, path,
                                               order):
    sim = _injection_deck(shape)
    sim.set_domain_particle_bc(vt.BOUNDARY(1, 0, 0), BO.absorb_tally())
    seen = []
    real = D.B.boundary_p

    def boundary_p(*a, **kw):
        seen.append("boundary_p")
        return real(*a, **kw)

    def injector(species, f, fcoef, acc, rhob, g, step, generator):
        seen.append("inject")
        return species, acc, rhob

    monkeypatch.setattr(D.B, "boundary_p", boundary_p)
    sim.user_particle_injection = injector
    state = sim.initialize()
    step = sim.make_step()
    assert step.path == path and not sim._residency_mode()[0]
    assert sim._live_bounds() == [2048]
    step(state)
    assert seen == order


def test_particle_hooks_need_the_generator():
    sim = _injection_deck()
    sim.user_particle_collisions = lambda species, f, g, step, gen: species
    state = sim.initialize()
    step = sim.make_step()
    step(state)
    sim._generator = None
    with pytest.raises(RuntimeError, match="generator"):
        step(state)
