"""The hand-written 3-D push and merge kernels against their plain PyTorch
versions, on the card.  Every test here is marked ``gpu`` and skips without
a CUDA device (decided inside the fixture, never at import).  This file
imports neither jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda3d.py

Tolerances: as tests/test_torch_cuda.py for the lanes (offsets and momenta
3e-5, voxels equal except at most 1 lane in 1e5 within 1e-5 of a face, the
accumulator 1e-5 max|acc|); emit marks and outbox rows equal for the lanes
and blocks whose voxels agree, outbox floats to 3e-5, ``ores`` equal; the
merge (one launch for every species, in place or into new tensors) bit for
bit in every lane.  Cases that drive the deposits' global
path (lanes outside their home brick, no home map, wraps across the
periodic faces of the edge bricks) are held to the same tolerances, and
the kernel's deposit count (FP3.deposits) to what the case implies."""

import re

import numpy as np
import pytest
import torch

import vpic_tpu_torch as vt
import vpic_tpu_torch.grid as G
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.interp as I
import vpic_tpu_torch.ops.residency as RES
from vpic_tpu_torch.models import harris
from vpic_tpu_torch.ops import _build
from vpic_tpu_torch.state import SPECIES_NAMES, SpeciesState

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _clone(species):
    return [sp.replace(**{n: getattr(sp, n).clone() for n in SPECIES_NAMES})
            for sp in species]


def _beam_deck(device):
    """1024 particles in one x-layer of cells at a brick edge, all streaming
    +x: every lane leaves its brick, and each block the beam fills has more
    leavers than its 128 outbox columns."""
    sim = vt.Simulation(seed=5, device=device)
    sim.define_units(1.0, 1.0)
    g0 = vt.partition_periodic_box(0, 0, 0, 1, 1, 1, 16, 16, 16)
    sim.define_timestep(0.6 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (16, 16, 16))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    el = sim.define_species("e", -1.0, 1.0, 24000, -1, 4, 1)
    rng = np.random.default_rng(0)
    for _ in range(1024):
        sim.inject_particle(el, 7.9 / 16, rng.uniform(0.01, 0.99),
                            rng.uniform(0.01, 0.99), 50.0, 0.0, 0.0, 1.0)
    return sim


def _sorted_state(sim):
    """The state after initialize() and the residency step's first
    rebucket: extent slices, brick-sorted with slack, and their homes."""
    state = sim.initialize()
    g = sim.grid
    res_on, slack = sim._residency_mode()
    assert res_on
    n0 = [st.count for st in sim.species]
    species, homes = [], []
    for sp, n, E in zip(state.species, n0, RES.extents(g, n0, slack)):
        s, h = FP3.brick_sort_p_home(RES.slice_species(sp, E), g, extent=n,
                                     slack=slack)
        species.append(s)
        homes.append(h)
    qms = [(st.params.q, st.params.m) for st in sim.species]
    return g, species, homes, I.load_interpolator(state.fields, g), qms


def _push_both(g, species, homes, fcoef, qms, residency=True):
    """The kernel (its deposit count reset before) and the plain version on
    the same lanes."""
    zeros = lambda: torch.zeros((g.nv, 12), device=fcoef.device)
    kw = dict(homes=homes, residency=residency)
    FP3.deposits = None
    k = FP3.fused_push3d_multi(_clone(species), fcoef, zeros(), g, qms, **kw)
    r = FP3.fused_push3d_multi_ref(_clone(species), fcoef, zeros(), g, qms,
                                   **kw)
    torch.cuda.synchronize()
    return k, r


def _compare_push(k, r):
    (sk, acc_k, em_k, obx_k, ores_k, unf_k) = k
    (sr, acc_r, em_r, obx_r, ores_r, unf_r) = r
    assert int(unf_k) == int(unf_r)
    residency = em_k is not None
    if residency:
        assert int(ores_k) == int(ores_r)
    else:
        em_k = em_r = [None] * len(sk)
    blk0 = 0
    for a, b, ea, eb in zip(sk, sr, em_k, em_r):
        live = a.live.cpu().numpy()
        diff = live & (a.i.cpu().numpy() != b.i.cpu().numpy())
        assert diff.sum() <= max(1, live.sum() // 100_000)
        keep = live & ~diff
        for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
            np.testing.assert_allclose(getattr(a, n).cpu().numpy()[keep],
                                       getattr(b, n).cpu().numpy()[keep],
                                       atol=3e-5, err_msg=n)
        if not residency:
            continue
        assert np.array_equal(ea.cpu().numpy()[~diff],
                              eb.cpu().numpy()[~diff])
        nb = a.capacity // FP3.BLOCK
        ok_blk = ~diff.reshape(nb, FP3.BLOCK).any(1)
        cols = ((blk0 + np.nonzero(ok_blk)[0])[:, None] * FP3.OUT_CAP
                + np.arange(FP3.OUT_CAP)[None, :]).reshape(-1)
        assert np.array_equal(obx_k.valid.cpu().numpy()[cols],
                              obx_r.valid.cpu().numpy()[cols])
        assert np.array_equal(obx_k.vox.cpu().numpy()[cols],
                              obx_r.vox.cpu().numpy()[cols])
        np.testing.assert_allclose(obx_k.f.cpu().numpy()[:, cols],
                                   obx_r.f.cpu().numpy()[:, cols], atol=3e-5)
        blk0 += nb
    da, db = acc_k.cpu().numpy(), acc_r.cpu().numpy()
    assert np.abs(da - db).max() <= 1e-5 * max(np.abs(db).max(), 1e-3)


def _deposits():
    """(global-path rounds, all rounds) of the kernel since its reset."""
    return tuple(FP3.deposits.tolist())


def _assert_merged_equal(mk, mr):
    for a, b in zip(mk, mr):
        for n in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w"):
            assert torch.equal(getattr(a, n).view(torch.int32),
                               getattr(b, n).view(torch.int32)), n
        assert torch.equal(a.live, b.live)
        assert int(a.np) == int(b.np) == int(a.live.sum())


def _merge_both(sk, em_k, obx_k, homes, g):
    """The kernel in place on a clone of the pushed lanes (one launch for
    every species), the plain version in place on another."""
    _, spid, usable = RES.static_layout([sp.capacity for sp in sk])
    free_j = RES.block_counts(sk, em_k)
    compact, starts_j, a_j, overflow, _ = RES.plan_exchange(
        obx_k, torch.cat(homes), spid, usable, free_j, g)
    ka, kb = _clone(sk), _clone(sk)
    before = RES.launches
    mk = RES.merge_p(ka, em_k, compact, starts_j, a_j, ka)
    assert RES.launches == before + 1
    mr = RES.merge_p_ref(kb, em_k, compact, starts_j, a_j, kb)
    torch.cuda.synchronize()
    _assert_merged_equal(mk, mr)
    return bool(overflow), int(a_j.sum())


def test_kernels_build_for_sm_90a(cuda):
    _build.build_many([FP3.KERNEL, RES.KERNEL, RES.PLAN_KERNEL])
    for name in (FP3.KERNEL, RES.KERNEL, RES.PLAN_KERNEL):
        assert "sm_90a" in _build.build_log(name)
    assert "0 bytes spill stores" in _build.build_log(RES.KERNEL)
    spills = re.findall(r"(\d+) bytes spill stores",
                        _build.build_log(RES.PLAN_KERNEL))
    assert len(spills) >= 4 and set(spills) == {"0"}


@pytest.mark.parametrize("nppc", [4, 16])
def test_kernels_match_plain_on_harris3d(cuda, nppc):
    sim = harris.build(harris.HarrisParams(
        nx=16, ny=16, nz=16, nppc=nppc, Lx=8.0, Ly=8.0, Lz=8.0,
        headroom=6.0 if nppc == 4 else 3.0), device=cuda)
    g, species, homes, fcoef, qms = _sorted_state(sim)
    k, r = _push_both(g, species, homes, fcoef, qms)
    _compare_push(k, r)
    assert sum(int(e.sum()) for e in k[2]) > 0
    overflow, placed = _merge_both(k[0], k[2], k[3], homes, g)
    assert not overflow and placed > 0


def test_kernels_on_outbox_overflow(cuda):
    """Every lane leaves its brick: each of the (2 x 2 bricks in y and z)
    blocks the beam fills emits its first 128 leavers in lane order and
    counts the rest into ores."""
    sim = _beam_deck(cuda)
    g, species, homes, fcoef, qms = _sorted_state(sim)
    k, r = _push_both(g, species, homes, fcoef, qms)
    _compare_push(k, r)
    filled = int((species[0].live.view(-1, FP3.BLOCK).any(1)).sum())
    assert filled == 4
    emitted = int(k[2][0].sum())
    assert emitted == filled * FP3.OUT_CAP
    assert int(k[4]) == 1024 - emitted > 0
    _merge_both(k[0], k[2], k[3], homes, g)


def test_kernels_on_lanes_outside_their_home_brick(cuda):
    """The beam's leavers past the outbox cap stay resident outside their
    home brick; pushed on with the same home maps they leave the tile's
    halo, and those rounds take the global path."""
    sim = _beam_deck(cuda)
    g, species, homes, fcoef, qms = _sorted_state(sim)
    kw = dict(homes=homes, residency=True)
    acc = torch.zeros((g.nv, 12), device=cuda)
    work = _clone(species)
    for _ in range(3):      # ~0.35 cells a push: into x-cell 9, the halo
        work, _, _, _, ores, _ = FP3.fused_push3d_multi(work, fcoef, acc, g,
                                                        qms, **kw)
        assert int(ores) > 0                       # resident leavers
    k, r = _push_both(g, work, homes, fcoef, qms)   # on into x-cell 10
    _compare_push(k, r)
    glob, every = _deposits()
    assert 0 < glob < every


def test_kernels_without_home_maps_take_the_global_path(cuda):
    """No home map (the push without residency): no tile, every round
    takes the global path."""
    sim = harris.build(harris.HarrisParams(
        nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0, headroom=6.0),
        device=cuda)
    g, species, _, fcoef, qms = _sorted_state(sim)
    k, r = _push_both(g, species, None, fcoef, qms, residency=False)
    _compare_push(k, r)
    glob, every = _deposits()
    live = sum(int(sp.live.sum()) for sp in species)
    assert glob == every >= live > 0


def _edge_lanes(g, n, axis, device, seed, capacity=16 * 1024):
    """``n`` live lanes (of ``capacity``) in the first and last cell layers
    along ``axis``, a cell or more from every other face, moving out
    through the ``axis`` faces at close to c."""
    rng = np.random.default_rng(seed)
    dims = (g.nx, g.ny, g.nz)
    hi = rng.random(capacity) < 0.5
    sgn = np.where(hi, 1.0, -1.0)
    cell = [rng.integers(2, m, capacity) for m in dims]
    cell[axis] = np.where(hi, dims[axis], 1)
    off = [rng.uniform(-1, 1, capacity) for _ in range(3)]
    off[axis] = sgn * rng.uniform(0.2, 1.0, capacity)
    u = [rng.normal(0, 0.5, capacity) for _ in range(3)]
    u[axis] = sgn * rng.uniform(2.0, 6.0, capacity)
    live = np.arange(capacity) < n
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=device)
    return SpeciesState(
        dx=t(off[0]), dy=t(off[1]), dz=t(off[2]),
        i=t(cell[0] + g.NX * (cell[1] + g.NY * cell[2]), torch.int32),
        ux=t(u[0]), uy=t(u[1]), uz=t(u[2]),
        w=t(rng.uniform(0.5, 1.5, capacity)), live=t(live, torch.bool),
        np=t(n, torch.int32))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_kernels_at_edge_bricks(cuda, axis):
    """Lanes of the domain's edge bricks moving out through the faces of
    one axis.  x has reflecting faces, as the harris deck: the lanes bounce
    and every round stays in the home brick's tile.  y and z are periodic:
    a round after a wrap lies across the domain from the tile and takes the
    global path."""
    g = G.partition_periodic_box(0, 0, 0, 1, 1, 1, 16, 16, 16, cvac=1.0,
                                 eps0=1.0)
    g = g.with_bc(0, pbc=G.REFLECT_PARTICLES).with_bc(
        3, pbc=G.REFLECT_PARTICLES)
    g = G.Grid(**{**g.__dict__, "dt": 0.95 * g.courant_length()})
    rng = np.random.default_rng(11)
    fcoef = torch.tensor(rng.normal(0, 0.3, (g.nv, 18)), dtype=torch.float32,
                         device=cuda)
    sorted_ = [FP3.brick_sort_p_home(_edge_lanes(g, 3000, axis, cuda, seed),
                                     g) for seed in (1, 2)]
    species = [s for s, _ in sorted_]
    homes = [h for _, h in sorted_]
    k, r = _push_both(g, species, homes, fcoef, [(-1.0, 1.0), (1.0, 1.5)])
    _compare_push(k, r)
    glob, every = _deposits()
    assert every >= 6000
    if axis == 0:
        assert glob == 0
    else:
        assert 0 < glob < every


@pytest.mark.parametrize("dest", ["aliased", "new"])
def test_merge_kernel_every_block_kind(cuda, dest):
    """Two species in one launch: dead blocks with junk lanes (and a -0.0
    that stays), blocks whose keepers stay (with a -0.0 the merge turns to
    +0.0), move a little or churn, with and without newcomers, dead lanes
    already zero, and a compact window that runs past the compact rows;
    merged in place or into new tensors."""
    rng = np.random.default_rng(5)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=cuda)
    species, emits = [], []
    for nb in (4, 3):
        N = nb * 1024
        live = np.zeros((nb, 1024), bool)
        live[1, :700] = True
        live[2, :900] = True
        emit = np.zeros((nb, 1024), bool)
        emit[1, 650:700] = True
        emit[2, rng.choice(900, 60, False)] = True
        if nb > 3:
            live[3, :1000] = True
            emit[3, :400] = True
        f = lambda: rng.normal(size=(nb, 1024))
        rows = {n: f() for n in ("dx", "dy", "dz", "ux", "uy", "uz")}
        rows["w"] = rng.uniform(0.5, 1.5, (nb, 1024))
        for n in rows:                  # block 2's dead lanes already zero
            rows[n][2, 900:] = 0.0
        rows["dx"][0, 5] = -0.0
        rows["w"][0, 9] = -0.0
        rows["ux"][1, 3] = -0.0
        vox = rng.integers(1, 4000, (nb, 1024))
        vox[2, 900:] = 0
        species.append(vt.SpeciesState(
            **{n: t(v.reshape(-1)) for n, v in rows.items()},
            i=t(vox.reshape(-1), torch.int32),
            live=t(live.reshape(-1), torch.bool),
            np=t(live.sum(), torch.int32)))
        emits.append(t(emit.reshape(-1), torch.bool))
    M = 600
    compact = FP3.Outbox(f=t(rng.normal(size=(7, M))),
                         vox=t(rng.integers(1, 4000, M), torch.int32),
                         valid=torch.ones(M, dtype=torch.bool, device=cuda))
    starts = t([0, 3, 200, 560, 0, 100, 590], torch.int32)
    a = t([0, 40, 128, 100, 0, 7, 30], torch.int32)
    ka, kb = _clone(species), _clone(species)
    out = ka if dest == "aliased" else [
        sp.replace(**{n: torch.full_like(getattr(sp, n), v) for n, v in
                      (("dx", float("nan")), ("dy", 1.0), ("dz", -0.0),
                       ("i", -3), ("ux", 2.0), ("uy", 3.0), ("uz", 4.0),
                       ("w", float("inf")), ("live", True))})
        for sp in ka]
    before = RES.launches
    mk = RES.merge_p(ka, emits, compact, starts, a, out)
    assert RES.launches == before + 1
    mr = RES.merge_p_ref(kb, emits, compact, starts, a, kb)
    torch.cuda.synchronize()
    _assert_merged_equal(mk, mr)
    for o, m in zip(out, mk):
        assert m.dx is o.dx and m.live is o.live
    dead = mk[0].dx[:1024]                           # the dead blocks
    assert torch.equal(dead.view(torch.int32),
                       species[0].dx[:1024].view(torch.int32))
    assert int(mk[0].w[9].view(torch.int32)) == 0
    assert int(mk[0].ux[1024 + 3].view(torch.int32)) == 0
    if dest == "new":                                # the input is untouched
        for n in FP3.LANE_FIELDS:
            assert torch.equal(getattr(ka[0], n), getattr(species[0], n))


def test_wrappers_reject_bad_inputs(cuda):
    sim = harris.build(harris.HarrisParams(
        nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0, headroom=6.0),
        device=cuda)
    g, species, homes, fcoef, qms = _sorted_state(sim)
    acc = torch.zeros((g.nv, 12), device=cuda)
    kw = dict(homes=homes, residency=True)
    with pytest.raises(ValueError):
        FP3.fused_push3d_multi(species, fcoef, acc, g, qms, residency=True)
    with pytest.raises(TypeError):
        FP3.fused_push3d_multi(species, fcoef, acc, g, qms,
                               homes=[h.long() for h in homes],
                               residency=True)
    with pytest.raises(ValueError):
        FP3.fused_push3d_multi(species, fcoef, acc.cpu(), g, qms, **kw)
    with pytest.raises(ValueError):
        FP3.fused_push3d_multi(species, fcoef, acc[:-1], g, qms, **kw)
    with pytest.raises(TypeError):
        FP3.fused_push3d_multi([species[0].replace(i=species[0].i.long())],
                               fcoef, acc, g, qms[:1], homes=homes[:1],
                               residency=True)
    k = FP3.fused_push3d_multi(_clone(species), fcoef, acc, g, qms, **kw)
    sk, em = k[0], k[2]
    _, spid, usable = RES.static_layout([sp.capacity for sp in sk])
    compact, starts_j, a_j, _, _ = RES.plan_exchange(
        k[3], torch.cat(homes), spid, usable, RES.block_counts(sk, em), g)
    launched = RES.launches
    with pytest.raises(TypeError):
        RES.merge_p(sk, em, compact, starts_j.long(), a_j, sk)
    with pytest.raises(ValueError):
        RES.merge_p(sk, em, compact._replace(vox=compact.vox.cpu()),
                    starts_j, a_j, sk)
    short = [sp.replace(**{n: getattr(sp, n)[:-1024] for n in
                           FP3.LANE_FIELDS}) for sp in sk]
    with pytest.raises(ValueError):
        RES.merge_p(short, em, compact, starts_j, a_j, short)
    with pytest.raises(ValueError):
        RES.merge_p([sk[0].replace(dx=sk[0].dx[:-1])], em[:1], compact,
                    starts_j, a_j, sk[:1])
    with pytest.raises(ValueError):                  # one species too few
        RES.merge_p(sk, em, compact, starts_j, a_j, sk[:1])
    N = sk[0].capacity
    buf = torch.empty(2 * N, device=cuda)
    buf[:N] = sk[0].dx
    with pytest.raises(ValueError):                  # overlaps its input
        RES.merge_p([sk[0].replace(dx=buf[:N])] + sk[1:], em, compact,
                    starts_j, a_j, [sk[0].replace(dx=buf[1024:N + 1024])]
                    + sk[1:])
    with pytest.raises(ValueError):                  # not 16-byte aligned
        RES.merge_p(sk, em, compact, starts_j, a_j,
                    [sk[0].replace(dx=torch.empty(N + 1, device=cuda)[1:])]
                    + sk[1:])
    assert RES.launches == launched                  # none was launched


@pytest.mark.parametrize("residency", [True, False])
def test_harris3d_on_card_matches_cpu(cuda, residency):
    """10 steps of a 16^3 harris on the card and on the CPU, through the
    residency step (headroom for its slack blocks) and through the
    per-step brick sort (none)."""
    p = harris.HarrisParams(nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0,
                            Lz=8.0, headroom=6.0 if residency else 1.5)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        sim = harris.build(p, device=dev)
        assert sim._residency_mode()[0] == residency
        runs.append((sim, sim.run(num_step=10, verbose=False)))
    (sg, gpu), (sc, cpu) = runs
    for n in ("jfx", "ex", "ey", "cbz"):
        a = getattr(cpu.fields, n).numpy()
        b = getattr(gpu.fields, n).cpu().numpy()
        assert np.abs(a - b).max() < 5e-7 + 1e-5 * np.abs(a).max(), n
    e_cpu = sc.energies(cpu).double().numpy()
    e_gpu = sg.energies(gpu).double().cpu().numpy()
    assert np.abs(e_cpu - e_gpu).max() / e_cpu.sum() < 1e-6
    assert int(gpu.diag["unfinished"]) == 0
    # run() steps the graphed step: the residency decision is read on the
    # host by its two eager warm-up steps (steps 0 and 1, each the first
    # of its cadence); the other eight replay the IF nodes
    assert sg.host_syncs == (2 if residency else 0)
    for a, b in zip(cpu.species, gpu.species):
        assert int(a.live.sum()) == int(b.live.sum())


def test_overflow_deck_rebuckets_on_card(cuda):
    """The deck's rebucket branch on the card: the beam overflows the
    outboxes, the step sorts instead of merging, and every particle stays,
    in the same cells as on the CPU."""
    runs = []
    for dev in (cuda, torch.device("cpu")):
        sim = _beam_deck(dev)
        state = sim.initialize()
        step = sim.make_step()
        for _ in range(3):
            state = step(state)
            assert int(state.species[0].live.sum()) == 1024
        runs.append(state)
    gpu, cpu = runs
    assert int(gpu.diag["_res_rebuckets"]) == int(cpu.diag["_res_rebuckets"])
    assert int(gpu.diag["_res_rebuckets"]) >= 1
    vox = [np.sort(s.species[0].i[s.species[0].live].cpu().numpy())
           for s in runs]
    assert np.array_equal(vox[0], vox[1])
