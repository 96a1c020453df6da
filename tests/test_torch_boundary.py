"""The port's particle boundary layer against vpic_tpu on the CPU, from the
same numpy inputs: the general walk with absorbing, custom and
per-voxel-face (vbc) faces, the push wrappers' plain versions with walls,
boundary_p with absorb_tally and link_boundary, and maxwellian_reflux.

Tolerances: lanes as tests/test_pallas.py:65-70 (offsets and momenta to
atol 3e-5, voxels equal), the accumulator to 1e-5 max|acc| (:71-72); pend
codes, live masks, tallies and link records' voxels equal; remaining
displacement to atol 3e-5; rhob to 1e-6 max|rhob| (its index_add order
differs from XLA's scatter).  Reflux draws from torch's generator, not
jax.random, so its velocities are held to their distribution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu.boundary as BJ
import vpic_tpu.boundary_ops as BOJ
import vpic_tpu.grid as GJ
import vpic_tpu.ops.push as PJ
import vpic_tpu.state as SJ
import vpic_tpu_torch.boundary as BT
import vpic_tpu_torch.boundary_ops as BOT
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fused_push as FP
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.move_p as MP
import vpic_tpu_torch.ops.push as PT
import vpic_tpu_torch.state as ST
from vpic_tpu_torch.interop import vbc_from_numpy

from torch_parity import assert_close_rel, np_

torch.set_num_threads(2)

LANE_FIELDS = ("dx", "dy", "dz", "ux", "uy", "uz")
C = PT.CUSTOM_BASE

# domain particle faces (-x -y -z +x +y +z; None: periodic)
FACES = {
    "absorb": (GT.ABSORB_PARTICLES, None, None, GT.ABSORB_PARTICLES, None,
               None),
    "custom": (GT.FIRST_CUSTOM_PBC, GT.REFLECT_PARTICLES, None,
               GT.FIRST_CUSTOM_PBC - 1, GT.REFLECT_PARTICLES, None),
    "mixed": (GT.ABSORB_PARTICLES, GT.FIRST_CUSTOM_PBC, None,
              GT.REFLECT_PARTICLES, GT.ABSORB_PARTICLES, None),
}


def _grids(shape, faces):
    nx, ny, nz = shape
    out = []
    for G in (GJ, GT):
        g = G.partition_periodic_box(0, 0, 0, 1.0, 0.75, 0.25 * nz, nx, ny,
                                     nz, dt=0.0, cvac=1.0, eps0=1.0)
        for f, bc in enumerate(faces):
            if bc is not None:
                g = g.with_bc(f, pbc=bc)
        out.append(G.Grid(**{**g.__dict__,
                             "dt": 0.95 * g.courant_length()}))
    return out


def _lanes(g, n, seed, u=4.0):
    """n lanes (90 % live) at random offsets in random interior voxels,
    with momenta that cross one or more faces in a step."""
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
        ux=f32(rng.normal(0, u, n)), uy=f32(rng.normal(0, u, n)),
        uz=f32(rng.normal(0, u, n)),
        w=f32(np.where(live, rng.uniform(0.5, 1.5, n), 0.0)),
        live=live, np=np.int32(live.sum()))


def _sp_torch(sp):
    return ST.SpeciesState(**{n: torch.from_numpy(np.array(getattr(sp, n)))
                              for n in ST.SPECIES_NAMES})


def _vbc(g, seed):
    """A (NZ, NY, NX, 6) int32 code table: a random quarter of the voxel
    faces reflect, absorb or park with a region handler's code."""
    rng = np.random.default_rng(seed)
    codes = np.array([0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                      GJ.REFLECT_PARTICLES, GJ.ABSORB_PARTICLES, C + 6,
                      C + 9], np.int32)
    return codes[rng.integers(0, len(codes), (g.NZ, g.NY, g.NX, 6))]


def _inputs(shape, faces, with_vbc, seed):
    gj, gt = _grids(shape, FACES[faces])
    sp = _lanes(gj, 4000, seed)
    rng = np.random.default_rng(seed + 1)
    fcoef = rng.normal(0, 0.3, (gj.nv, 18)).astype(np.float32)
    vbc = _vbc(gj, seed + 2) if with_vbc else None
    return gj, gt, sp, fcoef, vbc


def _advance_jax(gj, sp, fcoef, vbc, max_streak):
    return PJ.advance_p(sp, jnp.asarray(fcoef), gj, -1.0, 1.0,
                        jnp.zeros((gj.nv, 12), jnp.float32),
                        jnp.zeros(gj.nv, jnp.float32), max_streak=max_streak,
                        vbc=None if vbc is None else jnp.asarray(vbc)
                        .reshape(-1))


def assert_walk_matches(res_j, sp_t_out, pend_t, disp_t, acc_t, rhob_t,
                        live0):
    """Every lane live at the start: offsets, momenta, voxel, pend code,
    remaining displacement; then live masks, acc and rhob."""
    sj = res_j.species
    for n in LANE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(sj, n))[live0],
                                   np_(getattr(sp_t_out, n))[live0],
                                   atol=3e-5, err_msg=n)
    np.testing.assert_array_equal(np.asarray(sj.i)[live0],
                                  np_(sp_t_out.i)[live0])
    np.testing.assert_array_equal(np.asarray(sj.live), np_(sp_t_out.live))
    np.testing.assert_array_equal(np.asarray(res_j.pend_face), np_(pend_t))
    dj = np.stack([np.asarray(d) for d in res_j.pend_disp])
    np.testing.assert_allclose(dj[:, live0], np_(disp_t)[:, live0],
                               atol=3e-5)
    da, db = np.asarray(res_j.acc), np_(acc_t)
    assert np.abs(da - db).max() < 1e-5 * max(np.abs(da).max(), 1e-3)
    assert_close_rel(np.asarray(res_j.rhob_flat), rhob_t, 1e-6, 0.0, "rhob")


@pytest.mark.parametrize("shape,faces,with_vbc,max_streak", [
    ((6, 5, 1), "absorb", False, 4),
    ((6, 5, 1), "custom", False, 4),
    ((6, 5, 1), "mixed", True, 4),
    ((6, 5, 1), "absorb", True, 2),
    ((5, 4, 3), "mixed", True, 4),
    ((5, 4, 3), "custom", True, 4),
])
def test_advance_p_walls_match_jax(shape, faces, with_vbc, max_streak):
    """advance_p with absorbing, custom and vbc faces, relativistic lanes:
    multi-face walks, kills, parks, bounces and unfinished lanes."""
    gj, gt, sp, fcoef, vbc = _inputs(shape, faces, with_vbc,
                                     seed=len(faces) + max_streak)
    res_j = _advance_jax(gj, sp, fcoef, vbc, max_streak)
    acc_t = torch.zeros((gt.nv, 12))
    rhob_t = torch.zeros(gt.nv)
    res_t = PT.advance_p(_sp_torch(sp), torch.from_numpy(fcoef), gt, -1.0,
                         1.0, acc_t, rhob_t, max_streak=max_streak,
                         vbc=None if vbc is None
                         else vbc_from_numpy(vbc, "cpu"))
    assert res_t.acc is acc_t and res_t.rhob_flat is rhob_t
    live0 = np.asarray(sp.live)
    assert_walk_matches(res_j, res_t.species, res_t.pend_face,
                        torch.stack(res_t.pend_disp), acc_t, rhob_t, live0)
    pend = np_(res_t.pend_face)
    dead = live0 & ~np_(res_t.species.live)
    # the case exercises what it names
    if faces != "custom" or with_vbc:
        assert dead.any() and np.abs(np_(rhob_t)).max() > 0
    if faces != "absorb" or with_vbc:
        assert (pend >= C).any()
    if max_streak == 2:
        assert (pend == PT.UNFINISHED).any()
    assert int(res_t.species.np) == int(res_j.species.np)


@pytest.mark.parametrize("shape", [(6, 5, 1), (16, 16, 16)])
def test_push_wrappers_with_walls_match_advance_p(shape):
    """fused_push_multi / fused_push3d_multi on CPU tensors (their plain
    versions) with a Walls: lanes, pends, remaining displacement, acc and
    rhob as vpic_tpu's advance_p gives them; in 3-D residency, a lane parked
    at a wall is no brick-leaver."""
    faces = "mixed" if shape[2] == 1 else "custom"
    gj, gt, sp, fcoef, vbc = _inputs(shape, faces, True, seed=5)
    res_j = _advance_jax(gj, sp, fcoef, vbc, 4)
    walls = PT.Walls(torch.zeros(gt.nv), vbc_from_numpy(vbc, "cpu"))
    acc_t = torch.zeros((gt.nv, 12))
    args = ([_sp_torch(sp)], torch.from_numpy(fcoef), acc_t, gt,
            [(-1.0, 1.0)])
    live0 = np.asarray(sp.live)
    if shape[2] == 1:
        out, _, unf = FP.fused_push_multi(*args, walls=walls)
    else:
        n = sp.dx.shape[0]
        homes = [FP3.brick_of(torch.from_numpy(np.asarray(sp.i)), gt)
                 [::FP3.BLOCK].to(torch.int32)[:-(-n // FP3.BLOCK)]]
        out, _, emits, _, _, unf = FP3.fused_push3d_multi(
            *args, homes=homes, residency=True, walls=walls)
        parked = np_(walls.pends[0]) >= C
        assert parked.any() and not np_(emits[0])[parked].any()
    assert int(unf) == int((np.asarray(res_j.pend_face)
                            == PT.UNFINISHED).sum())
    assert_walk_matches(res_j, out[0], walls.pends[0], walls.disps[0],
                        acc_t, walls.rhob, live0)
    assert not np_(walls.disps[0])[:, ~live0].any()


@pytest.mark.parametrize("shape,faces", [
    ((6, 5, 1), "custom"), ((6, 5, 1), "mixed"), ((5, 4, 3), "mixed")])
def test_move_p_matches_jax_continue_walk(shape, faces):
    """ops/move_p (its plain version here) against vpic_tpu's
    _continue_walk: the lanes parked by a push walk on with a new remaining
    displacement against the domain faces (bounces, kills into rhob, parks
    again); lanes, pend codes, displacement, acc, rhob, live and w."""
    gj, gt, sp, fcoef, _ = _inputs(shape, faces, False, seed=21)
    res = _advance_jax(gj, sp, fcoef, None, 4)
    sp_j = res.species
    pend = np.asarray(res.pend_face)
    active = (pend >= C) & np.asarray(sp_j.live)
    assert active.sum() > 20
    rng = np.random.default_rng(22)
    disp = [np.where(active, rng.normal(0, 0.8, pend.shape), 0.0)
            .astype(np.float32) for _ in range(3)]
    pend0 = np.where(active, PT.DONE, pend).astype(np.int32)
    out_j = BOJ._continue_walk(
        sp_j, jnp.asarray(pend0), tuple(jnp.asarray(d) for d in disp),
        jnp.zeros((gj.nv, 12), jnp.float32), jnp.zeros(gj.nv, jnp.float32),
        gj, -1.0, jnp.asarray(active))
    acc_t, rhob_t = torch.zeros((gt.nv, 12)), torch.zeros(gt.nv)
    sp_t = _sp_torch(jax_np(sp_j))
    out_t = MP.move_p(sp_t, torch.from_numpy(pend0),
                      tuple(torch.from_numpy(d) for d in disp), acc_t,
                      rhob_t, gt, -1.0, torch.from_numpy(active))
    sj, st = out_j[0], out_t[0]
    live0 = np.asarray(sp_j.live)
    for n in LANE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(sj, n))[live0],
                                   np_(getattr(sp_t, n))[live0], atol=3e-5,
                                   err_msg=n)
    for n in ("i", "live", "w"):
        np.testing.assert_array_equal(np.asarray(getattr(sj, n)),
                                      np_(getattr(sp_t, n)), err_msg=n)
    assert int(st.np) == int(sj.np)
    np.testing.assert_array_equal(np.asarray(out_j[1]), np_(out_t[1]))
    np.testing.assert_allclose(
        np.stack([np.asarray(d) for d in out_j[2]])[:, live0],
        np.stack([np_(d) for d in out_t[2]])[:, live0], atol=3e-5)
    da, db = np.asarray(out_j[3]), np_(acc_t)
    assert np.abs(da - db).max() < 1e-5 * max(np.abs(da).max(), 1e-3)
    assert_close_rel(np.asarray(out_j[4]), rhob_t, 1e-6, 0.0, "rhob")
    # the case walks lanes on, and (mixed) kills some and parks others
    assert (np.abs(np_(st.dx) - np.asarray(sp_j.dx))[active] > 0).any()
    if faces == "mixed":
        assert (active & ~np_(st.live)).any() and \
            (np_(out_t[1])[active] >= C).any()


def test_push_refuses_walls_it_is_not_given():
    _, gt = _grids((6, 5, 1), FACES["absorb"])
    sp = _sp_torch(_lanes(gt, 64, 0))
    with pytest.raises(ValueError, match="walls"):
        FP.fused_push_multi([sp], torch.zeros((gt.nv, 18)),
                            torch.zeros((gt.nv, 12)), gt, [(-1.0, 1.0)])


def _parked(faces, seed):
    """A walked species in both packages with lanes parked at custom faces,
    and their pends and displacements (vpic_tpu's)."""
    gj, gt, sp, fcoef, vbc = _inputs((6, 5, 1), faces, False, seed)
    res = _advance_jax(gj, sp, fcoef, None, 4)
    sp_j = res.species
    return gj, gt, sp_j, _sp_torch(jax_np(sp_j)), res


def jax_np(sp):
    return SJ.SpeciesState(**{n: np.asarray(getattr(sp, n))
                              for n in ST.SPECIES_NAMES})


def _boundary_both(gj, gt, sp_j, sp_t, res, handlers_j, handlers_t,
                   diag_j, diag_t):
    spp = ST.SpeciesParams(name="e", q=-1.0, m=1.0, capacity=sp_t.capacity)
    acc_j = jnp.zeros((gj.nv, 12), jnp.float32)
    rhob_j = jnp.zeros(gj.nv, jnp.float32)
    out_j = BJ.boundary_p([sp_j], [spp], [res.pend_face], [res.pend_disp],
                          acc_j, rhob_j, gj, num_comm_round=3,
                          custom_handlers=handlers_j, diag=diag_j)
    pend_t = torch.from_numpy(np.array(res.pend_face))
    disp_t = torch.from_numpy(np.stack([np.asarray(d)
                                        for d in res.pend_disp]))
    out_t = BT.boundary_p([sp_t], [spp], [pend_t], [disp_t],
                          torch.zeros((gt.nv, 12)), torch.zeros(gt.nv), gt,
                          num_comm_round=3, custom_handlers=handlers_t,
                          diag=diag_t)
    return out_j, out_t


def test_boundary_p_absorb_tally_matches_jax():
    """absorb_tally on both custom x faces: the same lanes die, the tallies
    are equal, rhob agrees; the leftover drop takes nothing else."""
    gj, gt, sp_j, sp_t, res = _parked("custom", seed=11)
    spp = [ST.SpeciesParams(name="e", q=-1.0, m=1.0, capacity=1)]
    hj = {0: BOJ.absorb_tally(), 3: BOJ.absorb_tally()}
    ht = {0: BOT.absorb_tally(), 3: BOT.absorb_tally()}
    dj, dt = {}, {}
    for f in (0, 3):
        dj.update(hj[f].diag_init(spp, f))
        dt.update(ht[f].diag_init(spp, f))
    (sj, _, rj, nj, dj), (st, _, rt, nt, dt) = _boundary_both(
        gj, gt, sp_j, sp_t, res, hj, ht, dj, dt)
    parked = np.asarray(res.pend_face) >= C
    assert parked.sum() > 10
    for f in (0, 3):
        assert BOT.tally_of(dt, "e", f) == BOJ.tally_of(dj, "e", f) > 0
    assert int(nt) == int(nj) == 0
    np.testing.assert_array_equal(np.asarray(sj[0].live), np_(st[0].live))
    np.testing.assert_array_equal(np.asarray(sj[0].w), np_(st[0].w))
    assert int(st[0].np) == int(sj[0].np)
    assert_close_rel(np.asarray(rj), rt, 1e-6, 0.0, "rhob")


def test_boundary_p_link_boundary_matches_jax(tmp_path):
    """link_boundary records: the same count, voxels and particle rows in
    the same order, written to the same lines; records past the buffer are
    counted, not kept."""
    gj, gt, sp_j, sp_t, res = _parked("custom", seed=12)
    spp = [ST.SpeciesParams(name="e", q=-1.0, m=1.0, capacity=1)]
    lj = BOJ.link_boundary(prefix=str(tmp_path / "jax"), buffer_size=64)
    lt = BOT.link_boundary(prefix=str(tmp_path / "torch"), buffer_size=64)
    dj, dt = lj.diag_init(spp, 3), lt.diag_init(spp, 3)
    # the -x face parks with no handler: the leftover drop takes those
    (sj, _, rj, nj, dj), (st, _, rt, nt, dt) = _boundary_both(
        gj, gt, sp_j, sp_t, res, {3: lj}, {3: lt}, dj, dt)
    pend = np.asarray(res.pend_face)
    assert int(nt) == int(nj) == int((pend == C).sum()) > 0
    for leaf in ("n", "vox"):
        k = f"link/{tmp_path / 'torch'}/e/f3/{leaf}"
        kj = f"link/{tmp_path / 'jax'}/e/f3/{leaf}"
        np.testing.assert_array_equal(np.asarray(dj[kj]), np_(dt[k]))
    n = int(dt[f"link/{tmp_path / 'torch'}/e/f3/n"])
    assert 0 < n == int((pend == C + 3).sum())
    np.testing.assert_array_equal(
        np.asarray(dj[f"link/{tmp_path / 'jax'}/e/f3/buf"])[:n],
        np_(dt[f"link/{tmp_path / 'torch'}/e/f3/buf"])[:n])
    np.testing.assert_array_equal(np.asarray(sj[0].live), np_(st[0].live))
    assert_close_rel(np.asarray(rj), rt, 1e-6, 0.0, "rhob")
    dt2 = lt.write_links(dt)
    lj.write_links(dj)
    assert int(dt2[f"link/{tmp_path / 'torch'}/e/f3/n"]) == 0
    lines_t = open(f"{tmp_path / 'torch'}.0").read().splitlines()
    lines_j = open(f"{tmp_path / 'jax'}.0").read().splitlines()
    assert n > 64 and len(lines_t) == 64 and lines_t == lines_j


def _reflux_lanes(n, face, seed=3):
    """n live lanes parked at ``face`` of a 4^3 periodic box, each with a
    remaining displacement into the wall."""
    gj, gt = _grids((4, 4, 4), (None,) * 6)
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    ax = face % 3
    side = 1.0 if face >= 3 else -1.0
    pos = [f32(rng.uniform(-1, 1, n)) for _ in range(3)]
    pos[ax] = f32(np.full(n, side))
    coord = [rng.integers(1, 5, n) for _ in range(3)]
    coord[ax] = np.full(n, 4 if side > 0 else 1)
    disp = [f32(rng.uniform(-0.2, 0.2, n)) for _ in range(3)]
    disp[ax] = f32(side * rng.uniform(0.05, 0.3, n))
    u = f32(rng.normal(0, 0.5, (3, n)))
    sp = SJ.SpeciesState(
        dx=pos[0], dy=pos[1], dz=pos[2],
        i=np.asarray(coord[0] + gj.NX * (coord[1] + gj.NY * coord[2]),
                     np.int32),
        ux=u[0], uy=u[1], uz=u[2], w=f32(np.ones(n)),
        live=np.ones(n, bool), np=np.int32(n))
    pend = np.full(n, C + face, np.int32)
    return gj, gt, sp, pend, disp


@pytest.mark.parametrize("face", [0, 3, 4])
def test_maxwellian_reflux_statistics(face):
    """Every parked lane is re-emitted into the domain (none lost, its
    parallel momentum points inward) with the flux-weighted Rayleigh
    parallel and normal perpendicular momenta: mean sqrt(pi/2) ut_para and
    second moment 2 ut_para^2 along the face normal, mean 0 and variance
    ut_perp^2 across it, within 5 standard errors, in both packages."""
    n = 20000
    utp, utq = 0.15, 0.05
    gj, gt, sp, pend, disp = _reflux_lanes(n, face)
    spp = ST.SpeciesParams(name="e", q=-1e-6, m=1.0, capacity=n)
    ax = face % 3
    inward = -1.0 if face >= 3 else 1.0
    ht = BOT.maxwellian_reflux({"e": utp}, {"e": utq})
    gen = torch.Generator().manual_seed(0)
    sp_t = _sp_torch(sp)
    out = ht(gen, sp_t, torch.from_numpy(pend),
             tuple(torch.from_numpy(d) for d in disp),
             torch.zeros((gt.nv, 12)), torch.zeros(gt.nv), gt, spp, face,
             {})
    st, pend_t = out[0], out[1]
    hj = BOJ.maxwellian_reflux({"e": utp}, {"e": utq})
    import jax
    oj = hj(jax.random.PRNGKey(0), sp, jnp.asarray(pend),
            tuple(jnp.asarray(d) for d in disp),
            jnp.zeros((gj.nv, 12), jnp.float32),
            jnp.zeros(gj.nv, jnp.float32), gj, spp, face, {})
    assert st.live.all() and int(st.np) == n
    assert not (np_(pend_t) >= C).any()
    for u, what in ((np.stack([np_(st.ux), np_(st.uy), np_(st.uz)]), "port"),
                    (np.stack([np.asarray(oj[0].ux), np.asarray(oj[0].uy),
                               np.asarray(oj[0].uz)]), "jax")):
        par = inward * u[ax].astype(np.float64)
        assert (par > 0).all(), what
        se = np.sqrt((2 - np.pi / 2) * utp ** 2 / n)
        assert abs(par.mean() - np.sqrt(np.pi / 2) * utp) < 5 * se, what
        assert abs((par ** 2).mean() - 2 * utp ** 2) < \
            5 * np.sqrt(4 * utp ** 4 / n), what
        for a in ((ax + 1) % 3, (ax + 2) % 3):
            perp = u[a].astype(np.float64)
            assert abs(perp.mean()) < 5 * utq / np.sqrt(n), what
            assert abs(perp.var() - utq ** 2) < \
                5 * utq ** 2 * np.sqrt(2 / n), what


def test_handlers_ignore_dead_slots():
    """The push kernels leave the pend codes and displacement of slots
    dead when the push began unwritten: boundary_p, its leftover drop and
    every handler act on live lanes only, whatever such a slot holds; and
    maxwellian_reflux refuses to run without a generator."""
    n = 64
    gj, gt, sp, pend, disp = _reflux_lanes(n, 3, seed=7)
    live = np.arange(n) % 2 == 0
    sp = sp.replace(live=live, w=np.where(live, 1.0, 0.0).astype(np.float32),
                    np=np.int32(live.sum()))
    spp = ST.SpeciesParams(name="e", q=-1e-6, m=1.0, capacity=n)
    for handler in (BOT.maxwellian_reflux({"e": 0.1}, {"e": 0.05}),
                    BOT.absorb_tally(), None):
        sp_t = _sp_torch(sp)
        before = {f: np_(getattr(sp_t, f)).copy() for f in ST.SPECIES_NAMES
                  if f != "np"}
        handlers = {} if handler is None else {3: handler}
        diag = {} if handler is None or not hasattr(handler, "diag_init") \
            else handler.diag_init([spp], 3)
        rhob = torch.zeros(gt.nv)
        out = BT.boundary_p(
            [sp_t], [spp], [torch.from_numpy(pend)],
            [torch.from_numpy(np.stack(disp))], torch.zeros((gt.nv, 12)),
            rhob, gt, custom_handlers=handlers,
            generator=torch.Generator().manual_seed(0), diag=diag)
        st = out[0][0]
        for f, v in before.items():
            np.testing.assert_array_equal(np_(getattr(st, f))[~live],
                                          v[~live], err_msg=f)
        if handler is None:       # leftover drop: the live half only
            assert int(out[3]) == int(live.sum())
    with pytest.raises(ValueError, match="Generator"):
        BT.boundary_p([_sp_torch(sp)], [spp], [torch.from_numpy(pend)],
                      [torch.from_numpy(np.stack(disp))],
                      torch.zeros((gt.nv, 12)), torch.zeros(gt.nv), gt,
                      custom_handlers={3: BOT.maxwellian_reflux(
                          {"e": 0.1}, {"e": 0.05})})
