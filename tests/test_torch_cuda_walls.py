"""The two hand-written push kernels with wall faces (absorbing, custom and
per-voxel-face codes: their WALLS instance) and the reflux walk kernel
(move_p) against their plain PyTorch versions, and the decks that run
them, on the card.  Every test here is marked ``gpu`` and skips without
a CUDA device (decided inside the fixture, never at import).  This file
imports neither jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_walls.py

Tolerances (tests/test_torch_cuda.py's, and for the wall outputs): over the
lanes live when the push began, offsets, momenta and remaining
displacement to atol 3e-5; voxels, live masks and pend codes equal except
at most 1 lane in 1e5 that sits within 1e-5 of a face (fused multiply-add
in the Boris push moves a lane across a face it touches); the accumulator
to 1e-5 max|acc| and rhob to 1e-5 max|rhob| (float atomics reorder the
sums); in 3-D residency the emit marks and outbox columns equal."""

import numpy as np
import pytest
import torch

import vpic_tpu_torch.ops.fused_push as FP
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.interp as I
import vpic_tpu_torch.ops.move_p as MP
import vpic_tpu_torch.ops.push as PT
import vpic_tpu_torch.grid as G
from vpic_tpu_torch.models import lpi
from vpic_tpu_torch.state import SPECIES_NAMES, SpeciesState

pytestmark = pytest.mark.gpu

C = PT.CUSTOM_BASE


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _clone(species):
    return [sp.replace(**{n: getattr(sp, n).clone() for n in SPECIES_NAMES})
            for sp in species]


def push_both(fn, ref, g, species, fcoef, qms, vbc=None, **kw):
    """The kernel and the plain version on clones of the same lanes, each
    with its own accumulator and Walls (rhob from zero)."""
    out = []
    for f in (fn, ref):
        walls = PT.Walls(torch.zeros(g.nv, device=fcoef.device), vbc)
        acc = torch.zeros((g.nv, 12), device=fcoef.device)
        res = f(_clone(species), fcoef, acc, g, qms, walls=walls, **kw)
        out.append((res, acc, walls))
    torch.cuda.synchronize()
    return out


def compare_walls(species, kernel, plain):
    """Lanes, pends, remaining displacement, acc and rhob; returns the
    counts of lanes parked and killed by the kernel."""
    (rk, acc_k, wk), (rr, acc_r, wr) = kernel, plain
    parked = killed = 0
    for k, (s0, a, b) in enumerate(zip(species, rk[0], rr[0])):
        live0 = s0.live.cpu().numpy()
        diff = live0 & ((a.i != b.i) | (a.live != b.live)
                        | (wk.pends[k] != wr.pends[k])).cpu().numpy()
        assert diff.sum() <= max(1, live0.sum() // 100_000), k
        for sp in (a, b):
            pos = np.stack([getattr(sp, n).cpu().numpy()[diff]
                            for n in ("dx", "dy", "dz")])
            if diff.any():
                assert ((1.0 - np.abs(pos)).min(axis=0) <= 1e-5).all()
        keep = live0 & ~diff
        for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
            np.testing.assert_allclose(getattr(a, n).cpu().numpy()[keep],
                                       getattr(b, n).cpu().numpy()[keep],
                                       atol=3e-5, err_msg=n)
        np.testing.assert_allclose(wk.disps[k].cpu().numpy()[:, keep],
                                   wr.disps[k].cpu().numpy()[:, keep],
                                   atol=3e-5)
        dead = live0 & ~a.live.cpu().numpy()
        assert not a.w.cpu().numpy()[dead].any()
        assert int(a.np) == int(a.live.sum())
        parked += int(((wk.pends[k].cpu().numpy() >= C) & live0).sum())
        killed += int(dead.sum())
    da, db = acc_k.cpu().numpy(), acc_r.cpu().numpy()
    assert np.abs(da - db).max() <= 1e-5 * max(np.abs(db).max(), 1e-3)
    ra, rb = wk.rhob.cpu().numpy(), wr.rhob.cpu().numpy()
    assert np.abs(ra - rb).max() <= 1e-5 * max(np.abs(rb).max(), 1e-30)
    assert int(rk[2 if len(rk) == 3 else 5]) == \
        int(rr[2 if len(rr) == 3 else 5])         # unfinished
    return parked, killed


def _hot(g, n, seed, dev, u=4.0):
    """n lanes (90 % live) at random offsets in random interior voxels,
    with momenta that cross one or more faces in a step."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, g.nx + 1, n)
    y = rng.integers(1, g.ny + 1, n)
    z = rng.integers(1, g.nz + 1, n)
    live = rng.random(n) < 0.9
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a), dtype=dt,
                                                 device=dev)
    return SpeciesState(
        dx=t(rng.uniform(-1, 1, n)), dy=t(rng.uniform(-1, 1, n)),
        dz=t(rng.uniform(-1, 1, n)),
        i=t(x + g.NX * (y + g.NY * z), torch.int32),
        ux=t(rng.normal(0, u, n)), uy=t(rng.normal(0, u, n)),
        uz=t(rng.normal(0, u, n)),
        w=t(np.where(live, rng.uniform(0.5, 1.5, n), 0.0)),
        live=t(live, torch.bool), np=t(live.sum(), torch.int32))


def _vbc(g, seed, dev):
    rng = np.random.default_rng(seed)
    codes = np.array([0] * 12 + [G.REFLECT_PARTICLES, G.ABSORB_PARTICLES,
                                 C + 6, C + 9], np.int32)
    return torch.tensor(codes[rng.integers(0, len(codes), (g.nv, 6))],
                        device=dev)


def _walled(shape):
    nx, ny, nz = shape
    g = G.partition_periodic_box(0, 0, 0, 1.0, 0.75, 0.25 * nz, nx, ny, nz,
                                 dt=0.0, cvac=1.0, eps0=1.0)
    g = g.with_bc(0, pbc=G.ABSORB_PARTICLES).with_bc(
        3, pbc=G.FIRST_CUSTOM_PBC).with_bc(
        1, pbc=G.REFLECT_PARTICLES).with_bc(4, pbc=G.REFLECT_PARTICLES)
    return G.Grid(**{**g.__dict__, "dt": 0.95 * g.courant_length()})


@pytest.mark.parametrize("with_vbc", [False, True])
def test_push2d_walls_hot_lanes(cuda, with_vbc):
    """Relativistic unsorted lanes on an absorbing / custom / reflecting
    box, with and without a random per-voxel-face table: every rule, many
    multi-face walks, the global deposit path."""
    g = _walled((24, 20, 1))
    sp = _hot(g, 40_000, 1, cuda)
    fcoef = torch.randn((g.nv, 18), device=cuda) * 0.3
    vbc = _vbc(g, 2, cuda) if with_vbc else None
    qms = [(-1.0, 1.0)]
    parked, killed = compare_walls([sp], *push_both(
        FP.fused_push_multi, FP.fused_push_multi_ref, g, [sp], fcoef, qms,
        vbc))
    assert parked > 100 and killed > 100


@pytest.mark.parametrize("residency", [False, True])
def test_push3d_walls_hot_lanes(cuda, residency):
    """The same on a 16^3 box through the 3-D kernel; with residency the
    lanes parked or killed at a wall never reach the outbox."""
    g = _walled((16, 16, 16))
    n = 16 * 1024
    sp = _hot(g, n, 3, cuda)
    fcoef = torch.randn((g.nv, 18), device=cuda) * 0.3
    vbc = _vbc(g, 4, cuda)
    homes = [FP3.brick_of(sp.i, g)[::FP3.BLOCK].to(torch.int32)
             .contiguous()]
    (rk, acc_k, wk), (rr, acc_r, wr) = push_both(
        FP3.fused_push3d_multi, FP3.fused_push3d_multi_ref, g, [sp], fcoef,
        [(-1.0, 1.0)], vbc, homes=homes, residency=residency)
    parked, killed = compare_walls([sp], (rk, acc_k, wk), (rr, acc_r, wr))
    assert parked > 100 and killed > 100
    if residency:
        em_k, em_r = rk[2][0].cpu().numpy(), rr[2][0].cpu().numpy()
        assert np.array_equal(em_k, em_r)
        stopped = ((wk.pends[0] >= C) & sp.live).cpu().numpy() | \
            (sp.live & ~rk[0][0].live).cpu().numpy()
        assert not em_k[stopped].any()
        for name in ("valid", "vox"):
            assert torch.equal(getattr(rk[3], name), getattr(rr[3], name))
        assert int(rk[4]) == int(rr[4])


def test_push2d_walls_lpi(cuda):
    """The lpi deck at its published width (128 x 32, 16 ppc, reflux walls)
    after its first sort, kernel against plain; then 30 steps and again."""
    sim = lpi.build(lpi.LPIParams())
    state = sim.initialize()
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    sp = [FP.bucket_sort_p(s, g, extent=st.count)
          for s, st in zip(state.species, sim.species)]
    fcoef = I.load_interpolator(state.fields, g)
    compare_walls(sp, *push_both(FP.fused_push_multi, FP.fused_push_multi_ref,
                                 g, sp, fcoef, qms))
    step = sim.make_step()
    for _ in range(30):
        state = step(state)
    compare_walls(state.species, *push_both(
        FP.fused_push_multi, FP.fused_push_multi_ref, g, state.species,
        I.load_interpolator(state.fields, g), qms))


@pytest.mark.parametrize("shape", [(24, 20, 1), (10, 12, 9)])
def test_move_p_hot_lanes(cuda, shape):
    """move_p against its plain version: a random third of the live lanes
    walk a remaining displacement of up to a few cells on an absorbing /
    custom / reflecting box (bounces, kills into rhob, parks again,
    unfinished walks); the rest must stay as they were."""
    g = _walled(shape)
    n = 30_000
    sp = _hot(g, n, 5, cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    active = sp.live & (torch.rand(n, generator=gen, device=cuda) < 0.33)
    disp = tuple(torch.where(active, 1.5 * torch.randn(
        n, generator=gen, device=cuda), 0.0) for _ in range(3))
    pend = torch.where(active, PT.DONE, C + 3).to(torch.int32)
    outs = []
    for f in (MP.move_p, MP.move_p_ref):
        c = _clone([sp])[0]
        acc = torch.zeros((g.nv, 12), device=cuda)
        rhob = torch.zeros(g.nv, device=cuda)
        MP.launches = 0
        out = f(c, pend.clone(), tuple(d.clone() for d in disp), acc, rhob,
                g, -1.0, active)
        outs.append((c, out, acc, rhob, MP.launches))
    torch.cuda.synchronize()
    (a, oa, acc_k, rk, nk), (b, ob, acc_r, rr, nr) = outs
    assert (nk, nr) == (1, 0)
    live0 = sp.live.cpu().numpy()
    diff = live0 & ((a.i != b.i) | (a.live != b.live)
                    | (oa[1] != ob[1])).cpu().numpy()
    assert diff.sum() <= max(1, live0.sum() // 100_000)
    keep = live0 & ~diff
    for n_ in ("dx", "dy", "dz", "ux", "uy", "uz"):
        np.testing.assert_allclose(getattr(a, n_).cpu().numpy()[keep],
                                   getattr(b, n_).cpu().numpy()[keep],
                                   atol=3e-5, err_msg=n_)
    assert torch.equal(a.w, b.w) and int(oa[0].np) == int(ob[0].np)
    np.testing.assert_allclose(
        torch.stack(oa[2]).cpu().numpy()[:, keep],
        torch.stack(ob[2]).cpu().numpy()[:, keep], atol=3e-5)
    still = (~active).cpu().numpy()
    for n_ in ("dx", "i", "ux"):
        assert np.array_equal(getattr(a, n_).cpu().numpy()[still],
                              getattr(sp, n_).cpu().numpy()[still])
    da, db = acc_k.cpu().numpy(), acc_r.cpu().numpy()
    assert np.abs(da - db).max() <= 1e-5 * max(np.abs(db).max(), 1e-3)
    ra, rb = rk.cpu().numpy(), rr.cpu().numpy()
    assert np.abs(ra - rb).max() <= 1e-5 * max(np.abs(rb).max(), 1e-30)
    walked = active.cpu().numpy()
    assert (walked & ~a.live.cpu().numpy()).sum() > 50
    assert ((oa[1] >= C).cpu().numpy() & walked).sum() > 50


def _region_deck(shape, n, capacity, dev):
    """A periodic box with a centred absorbing region, ``n`` warm electrons
    outside it (test_region_pbc.py's decks, on ``dev``)."""
    import vpic_tpu_torch as vt
    nx, ny, nz = shape
    sim = vt.Simulation(seed=5, device=dev)
    sim.define_units(1.0, 1.0)
    lz = 1.0 if nz > 1 else 1.0 / nx
    g0 = vt.partition_periodic_box(0, 0, 0, 1.0, 1.0, lz, nx, ny, nz)
    sim.define_timestep(0.7 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, lz), shape)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    ele = sim.define_species("electron", -1.0, 1.0, capacity)
    inside = lambda x, y, z: (0.375 < x < 0.625) and (0.375 < y < 0.625) \
        and (nz == 1 or 0.375 < z < 0.625)
    rng = np.random.default_rng(1)
    k = 0
    while k < n:
        x, y, z = rng.uniform(0, 1, 3)
        z = z * lz
        if inside(x, y, z):
            continue
        sim.inject_particle(ele, x, y, z, *rng.normal(0, 0.3, 3),
                            w=1e-4)
        k += 1
    sim.set_region_particle_bc(inside, vt.ABSORB_PARTICLES)
    return sim


def test_region_decks_run_on_the_card(cuda):
    """The 2-D and 3-D (residency) interior-absorber decks step on the card
    through the WALLS kernels and agree with their CPU runs: the same
    survivors, rhob to 1e-5 max|rhob|."""
    for shape, n, cap in (((32, 32, 1), 20_000, 32_768),
                          ((16, 16, 16), 20_000, 65_536)):
        runs = []
        for dev in ("cuda", "cpu"):
            sim = _region_deck(shape, n, cap, dev)
            step = sim.make_step()
            assert step.path == ("push2d" if shape[2] == 1 else "push3d")
            state = sim.initialize()
            for _ in range(6):
                state = step(state)
            runs.append(state)
        a, b = runs
        assert int(a.species[0].np) == int(a.species[0].live.sum()) == \
            int(b.species[0].live.sum()) < n
        ra, rb = a.fields.rhob.cpu().numpy(), b.fields.rhob.numpy()
        assert np.abs(ra - rb).max() <= 1e-5 * np.abs(rb).max()


@pytest.mark.parametrize("wall", ["tally", "reflux"])
def test_general_path_runs_the_3d_kernel(cuda, wall):
    """A 3-D grid the bricks do not tile (nz = 9) with an absorbing region
    and custom x walls takes the general path: on the card one 3-D kernel
    launch a step (no home maps) and, with reflux, one move_p launch per
    handler run.  With absorb_tally walls (no randoms) the run agrees with
    its CPU run (the plain versions): the same survivors and tallies, rhob
    to 1e-5 max|rhob|; with reflux the card's run keeps np the live count
    and finite energies."""
    from vpic_tpu_torch import boundary_ops as BO
    runs = []
    for dev in ("cuda", "cpu") if wall == "tally" else ("cuda",):
        sim = _region_deck((16, 16, 9), 12_000, 16_384, dev)
        handler = BO.absorb_tally() if wall == "tally" else \
            BO.maxwellian_reflux({"electron": 0.3}, {"electron": 0.3})
        for face in (0, 3):
            sim.set_domain_particle_bc(face, handler)
        step = sim.make_step()
        assert step.path == "general"
        state = sim.initialize()
        FP3.launches = MP.launches = 0
        for _ in range(6):
            state = step(state)
        runs.append((sim, state, FP3.launches, MP.launches))
    sim, a, fa, ma = runs[0]
    walks = len(sim.pbc_handlers) * (1 + sim.num_comm_round) * 6
    assert (fa, ma) == (6, walks if wall == "reflux" else 0)
    assert int(a.species[0].np) == int(a.species[0].live.sum()) < 12_000
    assert torch.isfinite(sim.energies(a)).all()
    if wall == "tally":
        _, b, fb, mb = runs[1]
        assert (fb, mb) == (0, 0)
        assert int(a.species[0].np) == int(b.species[0].live.sum())
        for face in (0, 3):
            assert BO.tally_of(a.diag, "electron", face) == \
                BO.tally_of(b.diag, "electron", face)
        ra, rb = a.fields.rhob.cpu().numpy(), b.fields.rhob.numpy()
        assert np.abs(ra - rb).max() <= 1e-5 * np.abs(rb).max()
