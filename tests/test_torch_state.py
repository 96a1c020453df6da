"""Port state against vpic_tpu: the same harris deck (16^2 x 4 ppc) packs
bit-equal host arrays in both packages, interop round-trips bit-exactly,
and initialize() agrees to 5e-7 + 1e-5 max|a|."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import vpic_tpu.grid as grid_jax
import vpic_tpu_torch.grid as grid_torch
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.state import FIELD_NAMES, SPECIES_NAMES

from torch_parity import assert_close_rel, build_pair, np_, to_torch

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    sj, st = build_pair()
    return sj, st, sj.initialize(), st.initialize()


def test_grid_copy_matches():
    gj = grid_jax.partition_metal_box(0, 0, 0, 2.0, 3.0, 1.0, 8, 6, 1)
    gt = grid_torch.partition_metal_box(0, 0, 0, 2.0, 3.0, 1.0, 8, 6, 1)
    assert dataclasses.asdict(gj) == dataclasses.asdict(gt)
    for name in ("dx", "rdy", "nv", "sy", "sz", "shape"):
        assert getattr(gj, name) == getattr(gt, name)
    assert gt.courant_length() == gj.courant_length()


def test_flat_rank_is_not_ported():
    """flat_rank is this process's rank: 0 on one domain; a decomposed
    grid needs a mesh (tests/test_torch_mesh.py holds its order to
    vpic_tpu's)."""
    from vpic_tpu_torch.parallel import mesh as M
    assert grid_torch.flat_rank(grid_torch.Grid(nx=4, ny=4, nz=1)) == 0
    g = grid_torch.Grid(nx=4, ny=4, nz=1, topology=(1, 2, 1))
    with pytest.raises(RuntimeError, match="one process per rank"):
        grid_torch.flat_rank(g)
    with M.use(M.Mesh(1, 2, "cpu", "local")):
        assert grid_torch.flat_rank(g) == 1


# the 2-D deck, and a 3-D harris at the 3-D path's widths cut to 16^3
PACK_DECKS = {"2d": {}, "3d": dict(nx=16, ny=16, nz=16, nppc=2, Lx=8.0,
                                   Ly=8.0, Lz=8.0)}


@pytest.mark.parametrize("deck", sorted(PACK_DECKS))
def test_host_packs_bit_equal(deck):
    sj, st = build_pair(**PACK_DECKS[deck])
    spj, urbj, agej = sj._pack_species()
    spt, urbt, aget = st._pack_species()
    assert all(a is None for a in agej) and all(a is None for a in aget)
    for a, b, ua, ub in zip(spj, spt, urbj, urbt):
        for n in SPECIES_NAMES:
            x, y = np.asarray(getattr(a, n)), np_(getattr(b, n))
            assert x.dtype == y.dtype, n
            assert np.array_equal(x, y), n
        assert np.array_equal(np.asarray(ua), np_(ub))


def test_initial_fields_bit_equal():
    sj, st = build_pair()
    fj, ft = sj._build_initial_fields(), st._build_initial_fields()
    for n in FIELD_NAMES:
        assert np.array_equal(np.asarray(getattr(fj, n)),
                              np_(getattr(ft, n))), n


def test_material_coeffs_equal():
    sj, st = build_pair()
    mj, mt = sj._material_coeffs(), st._material_coeffs()
    for f in dataclasses.fields(mt):
        assert np.float32(np.asarray(getattr(mj, f.name))) == \
            np_(getattr(mt, f.name)), f.name


def test_interop_round_trip_bit_exact(pair):
    _, _, s_jax, _ = pair
    host = jax.device_get(s_jax)
    back = state_to_numpy(state_from_numpy(host, device="cpu"))
    for n in FIELD_NAMES:
        x, y = np.asarray(getattr(host.fields, n)), back["fields"][n]
        assert x.dtype == y.dtype and np.array_equal(x, y), n
    for sp, d in zip(host.species, back["species"]):
        for n in SPECIES_NAMES:
            x, y = np.asarray(getattr(sp, n)), d[n]
            assert x.dtype == y.dtype and np.array_equal(x, y), n
    assert back["step"] == int(host.step)


def test_state_to_numpy_is_a_copy(pair):
    _, _, _, s_t = pair
    host = state_to_numpy(s_t)
    host["fields"]["ex"][...] = 123.0
    assert not torch.any(s_t.fields.ex == 123.0)


@pytest.mark.parametrize("name", FIELD_NAMES)
def test_initialize_fields_match(pair, name):
    _, _, s_jax, s_t = pair
    assert_close_rel(getattr(s_jax.fields, name), getattr(s_t.fields, name),
                     1e-5, 5e-7, name)


@pytest.mark.parametrize("k", [0, 1])
def test_initialize_species_match(pair, k):
    _, _, s_jax, s_t = pair
    a, b = s_jax.species[k], s_t.species[k]
    for n in ("i", "live", "dx", "dy", "dz", "w"):
        assert np.array_equal(np.asarray(getattr(a, n)), np_(getattr(b, n)))
    for n in ("ux", "uy", "uz"):
        assert_close_rel(getattr(a, n), getattr(b, n), 1e-5, 5e-7, n)
    assert int(a.np) == int(b.np)
    assert b.np.dtype == torch.int32 and b.np.dim() == 0


def test_state_dtypes(pair):
    _, _, _, s_t = pair
    sp = s_t.species[0]
    assert sp.i.dtype == torch.int32 and sp.live.dtype == torch.bool
    assert s_t.step == 0 and isinstance(s_t.step, int)
    assert set(s_t.diag) == {"unfinished"}
    assert s_t.fields.ex.device.type == "cpu"


def test_to_torch_helper_matches_initialize(pair):
    _, _, s_jax, s_t = pair
    moved = to_torch(s_jax)
    assert_close_rel(moved.fields.cbz, s_t.fields.cbz, 1e-5, 5e-7)


def test_inject_particle_stages_vpic_tpu_rows():
    """inject_particle stages vpic_tpu's rows (with its age column): the
    double-precision conversion, x0 in the first cell and x1 folded into
    the last, and out-of-box particles skipped; the packs agree bit for
    bit."""
    import vpic_tpu as vj
    import vpic_tpu_torch as vt
    rng = np.random.default_rng(1)
    n = 500
    x = rng.uniform(-0.1, 2.1, n)
    x[:3] = (0.0, 2.0, 1.0)
    y, z = rng.uniform(0, 3.0, n), rng.uniform(0, 1.0, n)
    u = rng.normal(size=(3, n))
    w = rng.uniform(0.5, 1.5, n)
    sims = []
    for pkg, kw in ((vj, {}), (vt, {"device": "cpu"})):
        sim = pkg.Simulation(**kw)
        sim.define_periodic_grid((0, 0, 0), (2.0, 3.0, 1.0), (8, 6, 4))
        sp = sim.define_species("e", -1.0, 1.0, 2 * n)
        for k in range(n):
            sim.inject_particle(sp, x[k], y[k], z[k], *u[:, k], w[k])
        sims.append(sim)
    sj, st = sims
    rj = np.asarray(sj.species[0].xs, np.float64)
    rt = np.asarray(st.species[0].xs, np.float64)
    assert 1 < len(rt) < n and np.array_equal(rj, rt)
    assert tuple(rt[0, [0, 3]]) == (-1.0, 1) and \
        tuple(rt[1, [0, 3]]) == (1.0, 8)
    pa, pb = sj._pack_species()[0][0], st._pack_species()[0][0]
    for name in SPECIES_NAMES:
        x_, y_ = np.asarray(getattr(pa, name)), np_(getattr(pb, name))
        assert np.array_equal(x_, y_), name
