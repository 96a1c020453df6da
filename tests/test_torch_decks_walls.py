"""The port's walled sample decks (vpic_tpu_torch/models/sc08.py,
asymm4sp.py: PEC field faces and reflecting particle faces at +-x) against
vpic_tpu's on the CPU, where the port's step runs the plain versions of
its kernels:

(a) each deck built by both packages is the same build (grid, dt, face
    codes, step-loop settings, staged particle rows and set_region_field
    meshes exactly; tests/torch_parity.assert_same_build);
(b) 10 steps agree with vpic_tpu's general path (use_pallas=False): fields
    to 5e-7 + 1e-5 max|a|, energies to 1e-6 of their sum
    (tests/test_pallas.py:88-94), live counts equal; for sc08 (the general
    path, the 3-D push without home maps) the voxel multisets too, as
    tests/test_torch_deck3d.py holds them;
(c) the oracles: test_sample_decks.py::test_sc08_demo_runs_and_conserves
    and test_models.py::test_asymm4sp_runs_and_conserves on the port
    (through vpic_tpu_torch/scripts/deck_checks.py, as chip_smoke.py runs
    them on the card)."""

import numpy as np
import pytest
import torch

import vpic_tpu.models.asymm4sp as asymm4sp_jax
import vpic_tpu.models.sc08 as sc08_jax
from vpic_tpu_torch.models import asymm4sp, sc08
from vpic_tpu_torch.scripts import deck_checks as DC

from torch_parity import assert_same_build, np_, run_deck_pair

torch.set_num_threads(2)


def test_sc08_build_and_steps_match():
    kw = dict(nx=16, ny=8, nz=8, nppc=2)
    sj = sc08_jax.build(sc08_jax.SC08Params(**kw))
    st = sc08.build(sc08.SC08Params(**kw), device="cpu")
    assert_same_build(sj, st)
    a, b, _, _ = run_deck_pair(sj, st, 10, path="general")
    for x, y in zip(a.species, b.species):
        lx, ly = np.asarray(x.live), np_(y.live)
        assert lx.sum() == ly.sum() == len(st.species[0].xs)
        assert np.array_equal(np.sort(np.asarray(x.i)[lx]),
                              np.sort(np_(y.i)[ly]))


def test_asymm4sp_build_and_steps_match():
    kw = dict(nx=16, ny=16, nppc_sheet=4, nppc_bg=4, Lx=8.0, Ly=8.0)
    sj = asymm4sp_jax.build(asymm4sp_jax.Asymm4spParams(**kw))
    st = asymm4sp.build(asymm4sp.Asymm4spParams(**kw), device="cpu")
    assert_same_build(sj, st)
    run_deck_pair(sj, st, 10, path="push2d")


@pytest.mark.parametrize("kw", [dict(), dict(nx=150, ny=25, nz=100, nppc=1)])
def test_sc08_sizes_take_the_general_path(kw):
    """Neither the defaults (32 x 8 x 16: ny = 8 is below the 10-cell
    chart) nor the reference demo's 150 x 25 x 100 is tiled by the 8^3
    bricks; both take the general path with the push kernel's instance
    without wall code (PEC and reflecting faces only)."""
    from vpic_tpu_torch.ops import push as P
    from vpic_tpu_torch.ops import fused_push3d as FP3
    sim = sc08.build(sc08.SC08Params(**dict(kw, nppc=0.0)), device="cpu")
    g = sim.grid
    assert (g.nx, g.ny, g.nz) == (kw.get("nx", 32), kw.get("ny", 8),
                                  kw.get("nz", 16))
    assert sim._path()[0] == "general" and not FP3.supports3d(g)
    assert not P.has_walls(g, sim._local_vbc())
    assert sim.field_advance()[1] == "field_beb"


def test_sc08_oracle():
    """test_sample_decks.py::test_sc08_demo_runs_and_conserves on the
    port: every particle kept by the reflecting box, drift < 5e-3."""
    r = DC.oracle("sc08", "cpu", nx=16, ny=8, nz=8, nppc=2)
    assert r["steps"] == 15 and r["drift"] < 5e-3


def test_asymm4sp_oracle():
    """test_models.py::test_asymm4sp_runs_and_conserves on the port: four
    species, an asymmetric layer, drift < 5e-3 over 20 steps."""
    r = DC.oracle("asymm4sp", "cpu", nx=16, ny=16, nppc_sheet=8,
                  nppc_bg=8, Lx=8.0, Ly=8.0)
    assert len(r["sim"].species) == 4 and r["steps"] == 20
