"""The port's periodic sample decks (vpic_tpu_torch/models/twostream.py,
weibel_gold.py, beam_plas.py, force_free.py) against vpic_tpu's on the CPU,
where the port's step runs the plain versions of its kernels:

(a) each deck built by both packages is the same build: grid, dt, face
    codes, step-loop settings, the staged particle rows exactly and the
    set_region_field meshes exactly (tests/torch_parity.assert_same_build);
(b) 10 steps agree with vpic_tpu's general path (use_pallas=False; for
    twostream on tests/test_twostream.py's deck): fields
    to 5e-7 + 1e-5 max|a|, energies to 1e-6 of their sum
    (tests/test_pallas.py:88-94), live counts equal;
(c) the deck's oracle passes: tests/test_twostream.py's asserts on the port
    and, seed by seed, the port's 60-step energies within 1e-5 of their sum
    of vpic_tpu's from the same load (the two agree to 4e-7 at seeds 0-2,
    where the growth has amplified the float32 rounding for 60 steps);
    weibel_gold's reference stream (utils/vpic_rng) draw for draw;
    test_models.py::test_beam_plasma_two_stream's and
    test_sample_decks.py::test_force_free_energy_conservation's asserts
    (through vpic_tpu_torch/scripts/deck_checks.py, as chip_smoke.py runs
    them on the card)."""

import numpy as np
import pytest
import torch

import vpic_tpu.models.beam_plas as beam_plas_jax
import vpic_tpu.models.force_free as force_free_jax
import vpic_tpu.models.twostream as twostream_jax
import vpic_tpu.models.weibel_gold as weibel_gold_jax
import vpic_tpu.utils.vpic_rng as rng_jax
import vpic_tpu_torch.utils.vpic_rng as rng_torch
from vpic_tpu_torch.models import beam_plas, force_free, twostream, \
    weibel_gold
from vpic_tpu_torch.scripts import deck_checks as DC

from torch_parity import assert_same_build, run_deck_pair, to_torch

torch.set_num_threads(2)

SMALL = {
    "weibel_gold": (weibel_gold_jax, weibel_gold, "WeibelGoldParams",
                    dict(nppc=24), "push2d"),
    "beam_plas": (beam_plas_jax, beam_plas, "BeamPlasParams",
                  dict(nx=16, ny=4, Lx=8.0, nppc=16, seed=2), "push2d"),
    # 16^3 x 2 ppc: the 8^3 bricks tile it (brick sort every step)
    "force_free": (force_free_jax, force_free, "ForceFreeParams",
                   dict(nx=16, ny=16, nz=16, nppc=2, taui=1.0), "push3d"),
}


def build_pair(name, **kw):
    mj, mt, cls, params, path = SMALL[name]
    params = dict(params, **kw)
    return (mj.build(getattr(mj, cls)(**params)),
            mt.build(getattr(mt, cls)(**params), device="cpu"), path)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_periodic_deck_build_and_steps_match(name):
    sj, st, path = build_pair(name)
    assert_same_build(sj, st)
    run_deck_pair(sj, st, 10, path=path)


def test_deck_defaults_take_their_paths():
    """At their defaults the 1-D decks take the 2-D path at ny = nz = 1,
    and force_free's 32 x 16 x 16 the 3-D kernel path (the bricks tile it)
    with the brick sort every step: its capacity (1.2 x the load) has no
    room for a slack block per brick at any size, so residency stays off,
    as vpic_tpu's "auto" decides."""
    for mod, cls, path in ((twostream, "TwoStreamParams", "push2d"),
                           (weibel_gold, "WeibelGoldParams", "push2d"),
                           (beam_plas, "BeamPlasParams", "push2d"),
                           (force_free, "ForceFreeParams", "push3d")):
        sim = mod.build(getattr(mod, cls)(nppc=1.0), device="cpu")
        assert sim._path()[0] == path
    kw = dict(nppc=1.0)
    sim = force_free.build(force_free.ForceFreeParams(**kw), device="cpu")
    sj = force_free_jax.build(force_free_jax.ForceFreeParams(**kw))
    assert sim._residency_mode() == sj._residency_mode() == (False, 0)
    sj, st, _ = build_pair("force_free")
    assert st._residency_mode() == sj._residency_mode() == (False, 0)


def test_twostream_oracle_seed_by_seed():
    """tests/test_twostream.py's deck built by both packages: the same
    build, 10 steps to the ten-step tolerances, then its asserts on the
    port at step 60 (against step 2) and the port's energies against
    vpic_tpu's from the same load."""
    kw = dict(nx=64, nppc=48, v0=0.2, seed=0)
    sj = twostream_jax.build(twostream_jax.TwoStreamParams(**kw))
    st = twostream.build(twostream.TwoStreamParams(**kw), device="cpu")
    assert_same_build(sj, st)
    energies = lambda s: st.energies(s).double().numpy()
    b = st.initialize()
    e0 = energies(b)
    step = st.make_step()
    for _ in range(2):
        b = step(b)
    e_early = energies(b)
    a, b, adv, step = run_deck_pair(sj, st, 10, path="push2d")
    for _ in range(50):
        a, b = adv(a), step(b)
    e1 = energies(b)
    assert np.isfinite(e1).all()
    assert abs(e1.sum() - e0.sum()) / e0.sum() < 1e-2
    assert e1[0] > 8 * max(e_early[0], 1e-12)
    assert e1[0] > 2e-3
    assert e1[1] + e1[2] < 0.1 * e1[0]
    for s, sp in zip(st.species, b.species):
        assert int(sp.np) == s.count
    e1_j = energies(to_torch(a))
    assert np.abs(e1 - e1_j).max() < 1e-5 * e1_j.sum(), (e1, e1_j)


def test_weibel_gold_reference_stream():
    """The port's copy of utils/vpic_rng draws vpic_tpu's stream, and the
    deck loads from it as vpic_tpu's does."""
    for args in ((1, 2), (4, 3, 1, 2), (7, 2, 0, 1, 1, True)):
        a, b = rng_jax.entropy_rng(*args), rng_torch.entropy_rng(*args)
        for _ in range(40):
            assert a._next_u64() == b._next_u64()
        assert [a.uniform(-1.0, 2.0) for _ in range(50)] == \
            [b.uniform(-1.0, 2.0) for _ in range(50)]
        assert [a.normal(0.5, 0.1) for _ in range(300)] == \
            [b.normal(0.5, 0.1) for _ in range(300)]
    sim = weibel_gold.build(weibel_gold.WeibelGoldParams(nppc=2),
                            device="cpu")
    r = rng_jax.entropy_rng(1, 2)
    row = np.asarray(sim.species[0].xs[0], np.float64)
    x, y, z = r.uniform(0, sim.grid.x1), r.uniform(-0.5, 0.5), \
        r.uniform(-0.5, 0.5)
    ux = r.normal(0, 0.05 / np.sqrt(2.0))
    assert row[6] == ux and row[3] == int(16 * x / sim.grid.x1) + 1


def test_beam_plasma_oracle():
    """test_models.py::test_beam_plasma_two_stream's deck and asserts on
    the port (scripts/deck_checks.py, which chip_smoke.py runs on the
    card)."""
    DC.oracle("beam_plas", "cpu", nx=32, ny=2, Lx=16.0, Ly=1.0, nppc=32,
              u_beam=0.4)


def test_force_free_oracle():
    """test_sample_decks.py::test_force_free_energy_conservation on the
    port (16 x 8 x 8: ny = 8 is below the 10-cell chart, the general
    path)."""
    r = DC.oracle("force_free", "cpu", nx=16, ny=8, nz=8, nppc=4, taui=1.0)
    assert r["sim"].make_step().path == "general"
