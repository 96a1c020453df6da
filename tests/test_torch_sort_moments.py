"""Port sorts, particle moments and the voxel decode against vpic_tpu on
the same inputs: the port's initialized 16^2 x 4 ppc harris state, carried
to the JAX package as numpy.  Sorts are bit-exact; moments agree to 1e-6
(float32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu.grid as GJ
import vpic_tpu.ops.interp as IJ
import vpic_tpu.ops.pallas_push as PPJ
import vpic_tpu.ops.push as PJ
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fused_push as FP
import vpic_tpu_torch.ops.interp as IT
import vpic_tpu_torch.ops.push as PT
import vpic_tpu_torch.state as ST

from torch_parity import assert_close_rel, build_pair, np_, to_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def harris():
    sj, st = build_pair()
    s_t = st.initialize()
    s_jax = to_jax(s_t)
    return (sj, st, s_jax, s_t, IJ.load_interpolator(s_jax.fields, sj.grid),
            IT.load_interpolator(s_t.fields, st.grid))


@pytest.mark.parametrize("shape", [(16, 16, 1), (64, 64, 1), (7, 5, 4)])
def test_decode_voxel_every_voxel(shape):
    """Plain // and % against the JAX package's magic-number division on
    every voxel of the grid."""
    gj = GJ.Grid(*shape)
    gt = GT.Grid(*shape)
    i = np.arange(gj.nv, dtype=np.int32)
    zj, r = PJ.divmod_const(jnp.asarray(i), gj.sz, gj.nv)
    yj, xj = PJ.divmod_const(r, gj.sy, gj.sz)
    xt, yt, zt = PT.decode_voxel(torch.from_numpy(i), gt)
    for a, b in ((xj, xt), (yj, yt), (zj, zt)):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), np_(b))




def test_bucket_sort_matches_jax(harris):
    sj, st, s_jax, s_t, _, _ = harris
    for k in range(2):
        E = len(sj.species[k].xs)
        for extent in (0, E):
            a = PPJ.bucket_sort_p(s_jax.species[k], sj.grid, pack=1,
                                  extent=extent)
            b = FP.bucket_sort_p(s_t.species[k], st.grid, extent=extent)
            for n in ST.SPECIES_NAMES:
                assert np.array_equal(np.asarray(getattr(a, n)),
                                      np_(getattr(b, n))), (k, extent, n)


def test_bucket_sort_is_a_stable_permutation_live_first():
    g = GT.Grid(nx=40, ny=30, nz=1)
    rng = np.random.default_rng(3)
    N = 5000
    live = rng.random(N) < 0.7
    sp = ST.SpeciesState(
        dx=torch.zeros(N), dy=torch.zeros(N), dz=torch.zeros(N),
        i=torch.from_numpy(rng.integers(0, g.nv, N).astype(np.int32)),
        ux=torch.zeros(N), uy=torch.zeros(N), uz=torch.zeros(N),
        w=torch.arange(N, dtype=torch.float32),      # tags the source slot
        live=torch.from_numpy(live), np=torch.tensor(int(live.sum())))
    out = FP.bucket_sort_p(sp, g)
    src = np_(out.w).astype(np.int64)
    assert np.array_equal(np.sort(src), np.arange(N))          # permutation
    n_live = int(live.sum())
    assert np_(out.live)[:n_live].all() and not np_(out.live)[n_live:].any()
    b = np_(out.i)[:n_live] // FP.BUCKET
    assert (np.diff(b) >= 0).all()                             # grouped
    for key in np.unique(b):
        assert (np.diff(src[:n_live][b == key]) > 0).all()     # stable
    assert (np_(out.i)[n_live:] == 0).all()
    assert np.array_equal(np_(out.i)[:n_live],
                          np_(sp.i)[src[:n_live]])


def test_sort_p_matches_jax(harris):
    sj, _, s_jax, s_t, _, _ = harris
    a, b = PJ.sort_p(s_jax.species[1]), PT.sort_p(s_t.species[1])
    for n in ST.SPECIES_NAMES:
        assert np.array_equal(np.asarray(getattr(a, n)), np_(getattr(b, n)))


@pytest.mark.parametrize("fn", ["center_p", "uncenter_p"])
def test_center_uncenter_match_jax(harris, fn):
    sj, st, s_jax, s_t, fj, ft = harris
    spp = sj.species[0].params
    a = getattr(PJ, fn)(s_jax.species[0], fj, sj.grid, spp.q, spp.m)
    b = getattr(PT, fn)(s_t.species[0], ft, st.grid, spp.q, spp.m)
    for n in ("ux", "uy", "uz"):
        assert_close_rel(getattr(a, n), getattr(b, n), 1e-5, 5e-7, n)


def test_energy_p_matches_jax(harris):
    sj, st, s_jax, s_t, fj, ft = harris
    for k, s in enumerate(sj.species):
        a = PJ.energy_p(s_jax.species[k], fj, sj.grid, s.params.q, s.params.m)
        b = PT.energy_p(s_t.species[k], ft, st.grid, s.params.q, s.params.m)
        assert abs(float(a) - float(b)) <= 1e-6 * abs(float(a))


def test_accumulate_rho_p_matches_jax(harris):
    sj, st, s_jax, s_t, _, _ = harris
    g = sj.grid
    a = PJ.accumulate_rho_p(jnp.zeros(g.nv, jnp.float32), s_jax.species[0],
                            g, 1.0)
    b = PT.accumulate_rho_p(torch.zeros(g.nv), s_t.species[0], st.grid, 1.0)
    assert_close_rel(a, b, 1e-6)


def test_deposit_rhob_matches_jax():
    """Random lanes on a 3-D grid, edge cells included (the doubled
    boundary-node weights)."""
    gj, gt = GJ.Grid(nx=6, ny=5, nz=3), GT.Grid(nx=6, ny=5, nz=3)
    rng = np.random.default_rng(11)
    n = 500
    i = (rng.integers(1, 7, n) + gj.NX * (rng.integers(1, 6, n)
                                          + gj.NY * rng.integers(1, 4, n)))
    i = i.astype(np.int32)
    dx, dy, dz = (rng.uniform(-1, 1, n).astype(np.float32) for _ in "xyz")
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    mask = rng.random(n) < 0.5
    a = PJ.deposit_rhob(jnp.zeros(gj.nv, jnp.float32), gj, i, dx, dy, dz, w,
                        -1.0, mask)
    t = torch.from_numpy
    b = PT.deposit_rhob(torch.zeros(gt.nv), gt, t(i), t(dx), t(dy), t(dz),
                        t(w), -1.0, t(mask))
    assert_close_rel(a, b, 1e-6)
