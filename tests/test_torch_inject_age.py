"""Aged injection in the port (Simulation.inject_particle(age=...)): the
partial push u * age * cvac * dt / gamma at initialize(), through move_p
(misc.cc:80-99).  The four oracles of tests/test_inject_age.py, and the
port's initialize() against vpic_tpu's on a deck of a few thousand aged
lanes, some aimed at an absorbing wall: live masks and voxels equal, lanes
to 2e-6 (tests/test_inject_age.py:75), the fields to 1e-6 max|a|."""

import numpy as np
import pytest
import torch

import vpic_tpu as vj
import vpic_tpu_torch as vt
from vpic_tpu_torch import emitter as E

from torch_parity import assert_close_rel, np_

torch.set_num_threads(2)


def mk(age, x=0.53, capacity=100, pkg=vt):
    kw = {"device": "cpu"} if pkg is vt else {}
    sim = pkg.Simulation(seed=1, **kw)
    sim.define_units(1.0, 1.0)
    n = 16
    g0 = pkg.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, 1)
    sim.define_timestep(0.5 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    el = sim.define_species("e", -1.0, 1.0, capacity, -1, 4, 1)
    sim.inject_particle(el, x, 0.5, 0.5, 2.0, 0.5, 0.0, 1.0, age=age)
    return sim


def test_aged_injection_moves_particle():
    g = mk(0).grid
    sp0 = mk(0.0).initialize().species[0]
    sp1 = mk(0.5).initialize().species[0]
    ux, uy = 2.0, 0.5
    gam = np.sqrt(1 + ux * ux + uy * uy)
    aged = 0.5 * g.cvac * g.dt / gam
    assert abs(float(sp1.dx[0])
               - (float(sp0.dx[0]) + 2 * ux * aged * g.rdx)) < 1e-6
    assert abs(float(sp1.dy[0])
               - (float(sp0.dy[0]) + 2 * uy * aged * g.rdy)) < 1e-6
    assert int(sp1.i[0]) == int(sp0.i[0])
    assert float(sp1.ux[0]) == float(sp0.ux[0])     # kick-free


def test_aged_injection_crosses_cell():
    st0 = mk(0.0, x=0.559).initialize()
    st2 = mk(0.99, x=0.559).initialize()
    assert int(st2.species[0].i[0]) == int(st0.species[0].i[0]) + 1
    assert -1.0 <= float(st2.species[0].dx[0]) <= 1.0


def test_aged_injection_matches_runtime_inject():
    """The deck path and the device-side runtime_inject place an aged
    particle identically."""
    sim = mk(0.75, x=0.559)
    g = sim.grid
    sp_deck = sim.initialize().species[0]
    sp = mk(0.0, x=0.559).initialize().species[0]
    empty = sp.replace(live=torch.zeros_like(sp.live),
                       w=torch.zeros_like(sp.w),
                       np=torch.zeros((), dtype=torch.int32))
    one = lambda v: torch.tensor([v], dtype=torch.float32)
    sp_rt, _, _ = E.runtime_inject(
        empty, g, torch.zeros((g.nv, 12)), torch.zeros(g.nv), one(0.559),
        one(0.5), one(0.5), one(2.0), one(0.5), one(0.0), one(1.0), -1.0,
        age=one(0.75))
    for n in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w"):
        a = float(getattr(sp_deck, n)[0])
        b = float(getattr(sp_rt, n)[0])
        assert abs(a - b) <= 2e-6 * max(1.0, abs(a)), (n, a, b)


def wall_deck(pkg, lanes):
    """An absorbing +x wall (fields and particles); ``lanes`` rows (x, y,
    ux, uy, age)."""
    kw = {"device": "cpu"} if pkg is vt else {}
    sim = pkg.Simulation(seed=1, **kw)
    sim.define_units(1.0, 1.0)
    n = 16
    g0 = pkg.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, 1)
    sim.define_timestep(0.5 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, 1))
    sim.set_domain_field_bc(pkg.BOUNDARY(1, 0, 0), pkg.ABSORB_FIELDS)
    sim.set_domain_particle_bc(pkg.BOUNDARY(1, 0, 0), pkg.ABSORB_PARTICLES)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    el = sim.define_species("e", -1.0, 1.0, 2 * len(lanes) + 16, -1, 4, 1)
    for x, y, ux, uy, age in lanes:
        sim.inject_particle(el, x, y, 0.5, ux, uy, 0.0, 1.0, age=age)
    return sim


def test_aged_absorbing_wall_kills():
    """tests/test_inject_age.py:78-100: an aged walk into an absorbing wall
    kills the particle."""
    st = wall_deck(vt, [(1.0 - 1e-4, 0.5, 30.0, 0.0, 0.99)]).initialize()
    assert int(st.species[0].live.sum()) == 0 == int(st.species[0].np)


def test_aged_initialize_matches_jax():
    rng = np.random.default_rng(4)
    n = 3000
    lanes = np.stack([rng.uniform(0.0, 1.0, n), rng.uniform(0.0, 1.0, n),
                      rng.normal(0, 3.0, n), rng.normal(0, 3.0, n),
                      np.where(rng.uniform(size=n) < 0.2, 0.0,
                               rng.uniform(0, 1, n))], axis=1)
    lanes[:200, 0] = rng.uniform(0.95, 1.0, 200)     # aimed at the wall
    lanes[:200, 2] = np.abs(lanes[:200, 2]) + 20.0
    sj = wall_deck(vj, lanes)
    st = wall_deck(vt, lanes)
    a, b = sj.initialize(), st.initialize()
    spa, spb = a.species[0], b.species[0]
    live = np.asarray(spa.live)
    assert np.array_equal(live, np_(spb.live))
    assert 0 < (~live[:n]).sum() < 200 and int(spb.np) == live.sum()
    assert np.array_equal(np.asarray(spa.i), np_(spb.i))
    for name in ("dx", "dy", "dz", "ux", "uy", "uz", "w"):
        np.testing.assert_allclose(np.asarray(getattr(spa, name))[live],
                                   np_(getattr(spb, name))[live], rtol=0,
                                   atol=2e-6, err_msg=name)
    for name in ("ex", "ey", "cbz", "rhob", "rhof"):
        assert_close_rel(getattr(a.fields, name), getattr(b.fields, name),
                         1e-6, 0.0, name)


def test_staged_rows_carry_the_age():
    sim = mk(0.25)
    assert sim.species[0].xs[0][10] == 0.25
    species, _, ages = sim._pack_species()
    assert float(ages[0][0]) == 0.25 and not ages[0][1:].any()
    assert mk(0.0)._pack_species()[2] == (None,)
