"""Decomposed decks through the port's entry points, one Gloo rank per
domain on the CPU, against vpic_tpu under shard_map where it runs the same
deck (tests/test_sharded.py, tests/test_pallas3d.py:88-121): harris on
(1, 2, 1) and the 16^3 deck on (1, 2, 1) (the port's general path)
against vpic_tpu's sharded XLA step; weibel on (2, 2, 1) held to
vpic_tpu's own test's assertions (the pcomm round trip and lpi:
tests/test_torch_sharded_decks.py)."""

import numpy as np
import pytest

import vpic_tpu as vt
import vpic_tpu_torch as vtt
from vpic_tpu.models import harris as harris_jax
from vpic_tpu_torch.models import harris as harris_torch
from vpic_tpu_torch.models import weibel as weibel_torch
from vpic_tpu_torch.scripts import sharded_checks as SC
from torch_parity import launch_cpu

HARRIS = dict(nx=8, ny=8, nppc=8, Lx=8.0, Ly=8.0, seed=3, sort_interval=0)


def _run(sim, n_steps):
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(n_steps):
        state = step(state)
    return state


def _total_np(state):
    return int(sum(np.asarray(sp.np).sum() for sp in state.species))


def _deck3d(pkg, topology, device=None):
    """tests/test_pallas3d.py:88-121's 16^3 deck in either package."""
    kw = {} if device is None else {"device": device}
    sim = pkg.Simulation(seed=7, **kw)
    sim.define_units(1.0, 1.0)
    n = 16
    g0 = pkg.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, n, *topology)
    sim.define_timestep(0.6 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, n),
                             topology=topology)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    el = sim.define_species("e", -1.0, 1.0, 24000, -1, 4, 1)
    rng = np.random.default_rng(0)
    for k in range(4000):
        sim.inject_particle(el, *rng.uniform(0.01, 0.99, 3),
                            *rng.normal(0, 0.4, 3), 1.0)
    sim.set_region_field(
        pkg.everywhere, ey=lambda x, y, z: 0.05 * np.cos(2 * np.pi * x),
        bz=lambda x, y, z: 0.05 * np.cos(2 * np.pi * x))
    return sim


def _two_ranks():
    """harris (1, 2, 1), 6 steps, and the 16^3 deck (1, 2, 1), 4 steps:
    (energies, lanes of the ranks) of each, and the 3-D deck's path."""
    sim = harris_torch.build(harris_torch.HarrisParams(
        **HARRIS, topology=(1, 2, 1)), device="cpu")
    st = _run(sim, 6)
    out = dict(harris=(sim.energies(st).double().numpy(),
                       int(SC.total(_total_np(st), sim.grid))))
    sim = _deck3d(vtt, (1, 2, 1), "cpu")
    st = _run(sim, 4)
    out["deck3d"] = (sim.energies(st).double().numpy(),
                     int(SC.total(_total_np(st), sim.grid)),
                     sim.make_step().path)
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return launch_cpu(_two_ranks, 2, tmp_path_factory.mktemp("two"))


def test_sharded_harris_matches_jax(two_ranks):
    """tests/test_sharded.py:32-46: 6 steps of harris on (1, 2, 1) track
    vpic_tpu's sharded run of the same deck and load."""
    sim = harris_jax.build(harris_jax.HarrisParams(**HARRIS,
                                                   topology=(1, 2, 1)))
    sim.use_pallas = False
    st = _run(sim, 6)
    e_ref = np.asarray(sim.energies(st), np.float64)
    for e, n in (r["harris"] for r in two_ranks):
        assert n == _total_np(st)
        np.testing.assert_allclose(e, e_ref, rtol=5e-4,
                                   atol=1e-7 * e_ref.sum())


def test_sharded_deck3d_general_path_matches_jax(two_ranks):
    """tests/test_pallas3d.py:88-121's deck on (1, 2, 1): the port's
    general path (16 x 8 x 16 bricks are not tiled) against vpic_tpu's
    sharded XLA step, 4 steps."""
    sim = _deck3d(vt, (1, 2, 1))
    sim.use_pallas = False
    st = _run(sim, 4)
    e_ref = np.asarray(sim.energies(st), np.float64)
    n_ref = int(np.asarray(st.species[0].live).sum())
    for e, n, path in (r["deck3d"] for r in two_ranks):
        assert path == "general"
        assert n == n_ref == 4000
        assert np.abs(e - e_ref).max() / np.abs(e_ref).max() < 2e-5


def _weibel():
    p = weibel_torch.WeibelParams(nx=8, ny=8, nppc=8, Lx=8.0, Ly=8.0,
                                  topology=(2, 2, 1), sort_interval=0)
    sim = weibel_torch.build(p, device="cpu")
    state = sim.initialize()
    g = sim.grid
    n0 = int(SC.total(_total_np(state), g))
    e0 = sim.energies(state).double().numpy()
    step = sim.make_step()
    for _ in range(20):
        state = step(state)
    e1 = sim.energies(state).double().numpy()
    return n0, int(SC.total(_total_np(state), g)), e0, e1, \
        sim.migration["migrated"], int(sim.migration["n_dropped"])


def test_weibel_on_2x2_ranks_conserves(tmp_path):
    """tests/test_sharded.py:49-63 on the port: weibel on (2, 2, 1), 20
    steps with migration, particles and energy conserved."""
    for n0, n1, e0, e1, migrated, dropped in launch_cpu(_weibel, 4,
                                                        tmp_path):
        assert n1 == n0 and dropped == 0
        assert migrated > 0
        assert abs(e1.sum() - e0.sum()) / e0.sum() < 5e-3
