"""Port particle push against vpic_tpu, lane by lane: the general
advance_p and fused_push_multi's plain version against JAX advance_p (the
path tests/test_pallas.py holds the Pallas kernel to) at its tolerances
(test_pallas.py:65-72).  Sorts, moments and the voxel decode are in
test_torch_sort_moments.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu.grid as GJ
import vpic_tpu.ops.interp as IJ
import vpic_tpu.ops.pallas_push as PPJ
import vpic_tpu.ops.push as PJ
import vpic_tpu.state as SJ
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fused_push as FP
import vpic_tpu_torch.ops.interp as IT
import vpic_tpu_torch.ops.push as PT
import vpic_tpu_torch.state as ST
from vpic_tpu_torch.parallel import mesh as M

from torch_parity import build_pair, np_, to_torch

torch.set_num_threads(2)

LANE_FIELDS = ("dx", "dy", "dz", "ux", "uy", "uz")


@pytest.fixture(scope="module")
def harris():
    sj, st = build_pair()
    s_jax = sj.initialize()
    s_t = to_torch(s_jax)
    return (sj, st, s_jax, s_t, IJ.load_interpolator(s_jax.fields, sj.grid),
            IT.load_interpolator(s_t.fields, st.grid))


def assert_lanes_match(sp_j, sp_t):
    """test_pallas.py:65-70: offsets and momenta to atol 3e-5, voxels
    equal, over live lanes."""
    live = np.asarray(sp_j.live)
    for n in LANE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(sp_j, n))[live],
                                   np_(getattr(sp_t, n))[live], atol=3e-5,
                                   err_msg=n)
    np.testing.assert_array_equal(np.asarray(sp_j.i)[live], np_(sp_t.i)[live])


def assert_acc_match(acc_j, acc_t):
    """test_pallas.py:71-72."""
    da, db = np.asarray(acc_j), np_(acc_t)
    assert np.abs(da - db).max() < 1e-5 * max(np.abs(da).max(), 1e-3)


def _sp_torch(sp):
    return ST.SpeciesState(**{n: torch.from_numpy(np.array(getattr(sp, n)))
                              for n in ST.SPECIES_NAMES})


@pytest.mark.parametrize("k", [0, 1])
def test_advance_p_matches_jax(harris, k):
    sj, st, s_jax, s_t, fj, ft = harris
    g = sj.grid
    spp = sj.species[k].params
    acc0 = jnp.zeros((g.nv, 12), jnp.float32)
    res_j = PJ.advance_p(s_jax.species[k], fj, g, spp.q, spp.m, acc0,
                         jnp.zeros(g.nv, jnp.float32))
    acc_t = torch.zeros((g.nv, 12))
    res_t = PT.advance_p(s_t.species[k], ft, st.grid, spp.q, spp.m, acc_t)
    assert res_t.acc is acc_t
    assert_lanes_match(res_j.species, res_t.species)
    assert_acc_match(res_j.acc, res_t.acc)
    np.testing.assert_array_equal(np.asarray(res_j.pend_face),
                                  np_(res_t.pend_face))
    assert int(res_t.species.np) == int(res_j.species.np)


def test_fused_push_multi_ref_matches_jax(harris):
    """Both species into one accumulator, after the bucket sort the main
    path runs first."""
    sj, st, s_jax, s_t, fj, ft = harris
    g = sj.grid
    acc = jnp.zeros((g.nv, 12), jnp.float32)
    sps_t = [FP.bucket_sort_p(sp, st.grid) for sp in s_t.species]
    qms = [(s.params.q, s.params.m) for s in sj.species]
    out_t, acc_t, unf = FP.fused_push_multi_ref(
        sps_t, ft, torch.zeros((g.nv, 12)), st.grid, qms)
    assert int(unf) == 0
    for k, (q, m) in enumerate(qms):
        sp_j = PPJ.bucket_sort_p(s_jax.species[k], g, pack=1)
        res = PJ.advance_p(sp_j, fj, g, q, m, acc,
                           jnp.zeros(g.nv, jnp.float32))
        acc = res.acc
        assert_lanes_match(res.species, out_t[k])
    assert_acc_match(acc, acc_t)


def test_fused_push_multi_on_cpu_is_the_plain_version(harris):
    sj, st, s_jax, s_t, fj, ft = harris
    qms = [(s.params.q, s.params.m) for s in sj.species]
    before = FP.launches
    a, acc_a, _ = FP.fused_push_multi(list(s_t.species), ft,
                                      torch.zeros((st.grid.nv, 12)),
                                      st.grid, qms)
    b, acc_b, _ = FP.fused_push_multi_ref(list(s_t.species), ft,
                                          torch.zeros((st.grid.nv, 12)),
                                          st.grid, qms)
    assert FP.launches == before          # no kernel launch on CPU tensors
    assert torch.equal(acc_a, acc_b)
    for x, y in zip(a, b):
        for n in ST.SPECIES_NAMES:
            assert torch.equal(getattr(x, n), getattr(y, n)), n


def test_fused_push_multi_refuses_other_devices(harris):
    sj, st, s_jax, s_t, fj, ft = harris
    meta = ft.to("meta")
    with pytest.raises(ValueError, match="device"):
        FP.fused_push_multi(list(s_t.species), meta,
                            torch.zeros((st.grid.nv, 12), device="meta"),
                            st.grid, [(1.0, 1.0), (-1.0, 1.0)])


def _hot_lanes(g, n, seed):
    """n lanes at random offsets in random interior voxels with momenta
    large enough that many cross one or more faces in one step."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, g.nx + 1, n)
    y = rng.integers(1, g.ny + 1, n)
    z = rng.integers(1, g.nz + 1, n)
    f32 = lambda a: np.asarray(a, np.float32)
    live = rng.random(n) < 0.9
    return SJ.SpeciesState(
        dx=f32(rng.uniform(-1, 1, n)), dy=f32(rng.uniform(-1, 1, n)),
        dz=f32(rng.uniform(-1, 1, n)),
        i=np.asarray(x + g.NX * (y + g.NY * z), np.int32),
        ux=f32(rng.normal(0, 4, n)), uy=f32(rng.normal(0, 4, n)),
        uz=f32(rng.normal(0, 4, n)), w=f32(rng.uniform(0.5, 1.5, n)),
        live=live, np=np.int32(live.sum()))


def _hot_grids(shape):
    nx, ny, nz = shape
    out = []
    for G in (GJ, GT):
        g = G.partition_periodic_box(0, 0, 0, 1.0, 0.75, 0.25 * nz, nx, ny,
                                     nz, dt=0.0, cvac=1.0, eps0=1.0)
        g = g.with_bc(0, pbc=G.REFLECT_PARTICLES).with_bc(
            3, pbc=G.REFLECT_PARTICLES)
        dt = 0.95 * g.courant_length()
        out.append(G.Grid(**{**g.__dict__, "dt": dt}))
    return out


@pytest.mark.parametrize("shape,max_streak", [((6, 5, 1), 4),
                                              ((6, 5, 1), 2),
                                              ((5, 4, 3), 4)])
def test_streak_walk_crossings_match_jax(shape, max_streak):
    """Reflecting x walls, periodic y/z, relativistic lanes: multi-face
    walks, wraps, bounces and (max_streak=2) unfinished lanes."""
    gj, gt = _hot_grids(shape)
    sp = _hot_lanes(gj, 3000, seed=shape[2] + max_streak)
    rng = np.random.default_rng(7)
    fcoef = rng.normal(0, 0.3, (gj.nv, 18)).astype(np.float32)
    res_j = PJ.advance_p(sp, jnp.asarray(fcoef), gj, -1.0, 1.0,
                         jnp.zeros((gj.nv, 12), jnp.float32),
                         jnp.zeros(gj.nv, jnp.float32), max_streak=max_streak)
    res_t = PT.advance_p(_sp_torch(sp), torch.from_numpy(fcoef), gt, -1.0,
                         1.0, torch.zeros((gt.nv, 12)), max_streak=max_streak)
    assert_lanes_match(res_j.species, res_t.species)
    assert_acc_match(res_j.acc, res_t.acc)
    pend_j, pend_t = np.asarray(res_j.pend_face), np_(res_t.pend_face)
    np.testing.assert_array_equal(pend_j, pend_t)
    if max_streak == 2:
        assert (pend_t == PT.UNFINISHED).any()


@pytest.mark.parametrize("face_bc", ["remote", "3d", "decomposed"])
def test_supports_refuses(face_bc):
    g = GT.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 1)
    if face_bc == "remote":
        g = g.with_bc(1, pbc=GT.P_REMOTE)
    elif face_bc == "3d":
        g = GT.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 4)
    else:
        # a decomposed grid is no refusal any more: its remote faces are
        # wall faces of the rank, which the WALLS instance parks lanes at
        g = GT.Grid(**{**g.__dict__, "topology": (2, 1, 1),
                       "particle_bc": (GT.P_REMOTE, 0, 0, GT.P_REMOTE, 0,
                                       0)})
        with M.use(M.Mesh(1, 2, "cpu", "local")):
            assert FP.supports(g) and PT.has_walls(g)
        return
    with pytest.raises(NotImplementedError):
        FP.supports(g)


@pytest.mark.parametrize("face_bc", ["absorb", "custom", "half_periodic"])
def test_supports_walls(face_bc):
    """Faces the 2-D kernel takes through its WALLS instance (each face's
    own rule): absorbing, custom, and an axis periodic on one side only;
    a push without a Walls refuses them."""
    g = GT.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 1)
    bc = dict(absorb=GT.ABSORB_PARTICLES, custom=GT.FIRST_CUSTOM_PBC,
              half_periodic=GT.REFLECT_PARTICLES)[face_bc]
    g = g.with_bc(0, pbc=bc)
    assert FP.supports(g) and PT.has_walls(g)
    sp = ST.SpeciesState(**{n: torch.zeros(8, dtype=torch.int32 if n == "i"
                                           else torch.bool if n == "live"
                                           else torch.float32)
                            for n in ST.SPECIES_NAMES})
    with pytest.raises(ValueError, match="walls"):
        FP.fused_push_multi([sp], torch.zeros((g.nv, 18)),
                            torch.zeros((g.nv, 12)), g, [(1.0, 1.0)])


def test_advance_p_refuses_unported_faces(harris):
    """What needs particle migration is refused: a remote face and a
    decomposed grid (absorbing, custom and vbc faces are walked; see
    test_torch_boundary.py)."""
    sj, st, s_jax, s_t, fj, ft = harris
    acc = torch.zeros((st.grid.nv, 12))
    remote = st.grid.with_bc(1, pbc=GT.P_REMOTE).with_bc(4, pbc=GT.P_REMOTE)
    with pytest.raises(NotImplementedError, match="remote"):
        PT.advance_p(s_t.species[0], ft, remote, 1.0, 1.0, acc)
    # a decomposed grid needs this process's rank (tests/
    # test_torch_sharded_push.py runs the push under a mesh)
    sharded = GT.Grid(**{**st.grid.__dict__, "topology": (1, 2, 1)})
    with pytest.raises(RuntimeError, match="one process per rank"):
        PT.advance_p(s_t.species[0], ft, sharded, 1.0, 1.0, acc)


def test_supports_harris():
    _, st = build_pair()
    assert FP.supports(st.grid)
