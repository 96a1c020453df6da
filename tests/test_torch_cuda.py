"""The hand-written CUDA push kernel against its plain PyTorch version, on
the card.  Every test here is marked ``gpu`` and skips without a CUDA
device (decided inside the fixture, never at import).  This file imports
neither jax nor vpic_tpu, so it also runs where only PyTorch is installed:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda.py

Tolerances: offsets and momenta to atol 3e-5 (test_pallas.py:68), voxels
equal except at most 1 lane in 1e5 that sits within 1e-5 of a face (fused
multiply-add moves a lane across a face it touches), the accumulator to
1e-5 max|acc| (atomics reorder the sums).  Cases that drive the deposits'
global path (unsorted lanes, wraps across periodic faces) are held to the
same tolerances, and the kernel's deposit count (FP.deposits) to what the
case implies."""

import numpy as np
import pytest
import torch

import vpic_tpu_torch.grid as G
import vpic_tpu_torch.ops.fused_push as FP
import vpic_tpu_torch.ops.interp as I
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


def _compare(sk, acc_k, sr, acc_r):
    for a, b in zip(sk, sr):
        live = a.live.cpu().numpy()
        diff = a.i.cpu().numpy()[live] != b.i.cpu().numpy()[live]
        assert diff.sum() <= max(1, live.sum() // 100_000)
        for sp in (a, b):
            pos = np.stack([getattr(sp, n).cpu().numpy()[live][diff]
                            for n in ("dx", "dy", "dz")])
            if diff.any():
                assert ((1.0 - np.abs(pos)).min(axis=0) <= 1e-5).all()
        for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
            np.testing.assert_allclose(
                getattr(a, n).cpu().numpy()[live][~diff],
                getattr(b, n).cpu().numpy()[live][~diff], atol=3e-5,
                err_msg=n)
    da, db = acc_k.cpu().numpy(), acc_r.cpu().numpy()
    assert np.abs(da - db).max() <= 1e-5 * max(np.abs(db).max(), 1e-3)


def _push_both(species, fcoef, g, qms, max_streak=4):
    zeros = lambda: torch.zeros((g.nv, 12), device=fcoef.device)
    sk, acc_k, unf_k = FP.fused_push_multi(_clone(species), fcoef, zeros(),
                                           g, qms, max_streak=max_streak)
    sr, acc_r, unf_r = FP.fused_push_multi_ref(_clone(species), fcoef,
                                               zeros(), g, qms,
                                               max_streak=max_streak)
    torch.cuda.synchronize()
    return (sk, acc_k, int(unf_k)), (sr, acc_r, int(unf_r))


def _counted_push(species, fcoef, g, qms, max_streak=4):
    """_push_both with the kernel's deposit count reset before; returns
    its results and (global-path rounds, all rounds)."""
    FP.deposits = None
    out = _push_both(species, fcoef, g, qms, max_streak)
    return out, tuple(FP.deposits.tolist())


def test_kernel_builds_for_sm_90a(cuda):
    _build.build(FP.KERNEL)
    log = _build.build_log(FP.KERNEL)
    assert "sm_90a" in log
    assert "0 bytes spill stores" in log


@pytest.mark.parametrize("nx,nppc", [(16, 4), (64, 64)])
def test_kernel_matches_plain_on_harris(cuda, nx, nppc):
    sim = harris.build(harris.HarrisParams(nx=nx, ny=nx, nppc=nppc,
                                           Lx=nx / 4, Ly=nx / 4),
                       device=cuda)
    state = sim.initialize()
    g = sim.grid
    species = [FP.bucket_sort_p(sp, g) for sp in state.species]
    fcoef = I.load_interpolator(state.fields, g)
    qms = [(s.params.q, s.params.m) for s in sim.species]
    (sk, acc_k, unf_k), (sr, acc_r, unf_r) = _push_both(species, fcoef, g,
                                                        qms)
    assert unf_k == unf_r == 0
    _compare(sk, acc_k, sr, acc_r)


def _hot(g, n, device, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, g.nx + 1, n)
    y = rng.integers(1, g.ny + 1, n)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=device)
    live = rng.random(n) < 0.9
    return SpeciesState(
        dx=t(rng.uniform(-1, 1, n)), dy=t(rng.uniform(-1, 1, n)),
        dz=t(rng.uniform(-1, 1, n)),
        i=t(x + g.NX * (y + g.NY), torch.int32),
        ux=t(rng.normal(0, 4, n)), uy=t(rng.normal(0, 4, n)),
        uz=t(rng.normal(0, 4, n)), w=t(rng.uniform(0.5, 1.5, n)),
        live=t(live, torch.bool), np=t(live.sum(), torch.int32))


@pytest.mark.parametrize("max_streak", [4, 2])
def test_kernel_matches_plain_on_crossings(cuda, max_streak):
    """Relativistic lanes: multi-face walks, periodic wraps in y and z,
    bounces off the reflecting x walls, unfinished lanes at max_streak 2."""
    g = G.partition_periodic_box(0, 0, 0, 1.0, 0.75, 0.25, 6, 5, 1,
                                 cvac=1.0, eps0=1.0)
    g = g.with_bc(0, pbc=G.REFLECT_PARTICLES).with_bc(
        3, pbc=G.REFLECT_PARTICLES)
    g = G.Grid(**{**g.__dict__, "dt": 0.95 * g.courant_length()})
    rng = np.random.default_rng(5)
    fcoef = torch.tensor(rng.normal(0, 0.3, (g.nv, 18)), dtype=torch.float32,
                         device=cuda)
    species = [_hot(g, 20000, cuda, seed) for seed in (1, 2)]
    (sk, acc_k, unf_k), (sr, acc_r, unf_r) = _push_both(
        species, fcoef, g, [(-1.0, 1.0), (1.0, 1.5)], max_streak)
    assert unf_k == unf_r
    assert (unf_k > 0) == (max_streak == 2)
    _compare(sk, acc_k, sr, acc_r)


def test_kernel_updates_in_place_and_counts(cuda):
    g = G.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 1)
    g = G.Grid(**{**g.__dict__, "dt": 0.5 * g.courant_length()})
    sp = _hot(g, 1000, cuda, seed=3)
    fcoef = torch.zeros((g.nv, 18), device=cuda)
    acc = torch.zeros((g.nv, 12), device=cuda)
    before = FP.launches
    dx0 = sp.dx.clone()
    out, acc_out, _ = FP.fused_push_multi([sp, sp], fcoef, acc, g,
                                          [(1.0, 1.0), (1.0, 1.0)])
    torch.cuda.synchronize()
    assert FP.launches == before + 1         # one launch for every species
    assert out[0] is sp and acc_out is acc
    assert not torch.equal(sp.dx, dx0)


@pytest.mark.parametrize("nsp,launches", [(3, 1), (9, 2)])
def test_kernel_takes_every_species_in_one_launch(cuda, nsp, launches):
    """MAX_SPECIES species to a launch, each with its own charge and mass,
    the lane counts not multiples of a block."""
    g = G.partition_periodic_box(0, 0, 0, 1, 1, 1, 16, 16, 1)
    g = G.Grid(**{**g.__dict__, "dt": 0.5 * g.courant_length()})
    rng = np.random.default_rng(8)
    fcoef = torch.tensor(rng.normal(0, 0.3, (g.nv, 18)), dtype=torch.float32,
                         device=cuda)
    species = [FP.bucket_sort_p(_hot(g, 700 + 300 * k, cuda, seed=10 + k), g)
               for k in range(nsp)]
    qms = [((-1.0) ** k, 1.0 + 0.5 * k) for k in range(nsp)]
    before = FP.launches
    (sk, acc_k, unf_k), (sr, acc_r, unf_r) = _push_both(species, fcoef, g,
                                                        qms)
    assert FP.launches == before + launches
    assert unf_k == unf_r
    _compare(sk, acc_k, sr, acc_r)


def test_kernel_on_unsorted_lanes(cuda):
    """Lanes in a random order: every block's voxel range is wider than
    its tile, which is then cut at a quarter of the grid from the lowest
    voxel, so most rounds take the global path."""
    sim = harris.build(harris.HarrisParams(nx=64, ny=64, nppc=16, Lx=16.0,
                                           Ly=16.0), device=cuda)
    state = sim.initialize()
    g = sim.grid
    rng = np.random.default_rng(6)
    species = []
    for sp in state.species:
        perm = torch.tensor(rng.permutation(sp.capacity), device=cuda)
        species.append(sp.replace(**{n: getattr(sp, n)[perm] for n in
                                     SPECIES_NAMES if n != "np"}))
    fcoef = I.load_interpolator(state.fields, g)
    qms = [(s.params.q, s.params.m) for s in sim.species]
    ((sk, acc_k, unf_k), (sr, acc_r, unf_r)), (glob, every) = _counted_push(
        species, fcoef, g, qms)
    assert unf_k == unf_r == 0
    _compare(sk, acc_k, sr, acc_r)
    assert every // 2 < glob < every


def test_kernel_on_sorted_harris_keeps_rounds_in_tiles(cuda):
    """Right after the bucket sort fewer than 1 % of the rounds take the
    global path (y-wraps of the periodic faces, a block's edge)."""
    sim = harris.build(harris.HarrisParams(), device=cuda)
    state = sim.initialize()
    g = sim.grid
    species = [FP.bucket_sort_p(sp, g) for sp in state.species]
    fcoef = I.load_interpolator(state.fields, g)
    qms = [(s.params.q, s.params.m) for s in sim.species]
    ((sk, acc_k, _), (sr, acc_r, _)), (glob, every) = _counted_push(
        species, fcoef, g, qms)
    _compare(sk, acc_k, sr, acc_r)
    live = sum(int(sp.live.sum()) for sp in species)
    assert every >= live and glob < every // 100


def _wrap_lanes(g, n, device, seed):
    """Lanes in the first and last rows of a periodic box, moving out
    through the y faces at close to c, so most wrap to the far row."""
    rng = np.random.default_rng(seed)
    top = rng.random(n) < 0.5
    x = rng.integers(1, g.nx + 1, n)
    y = np.where(top, g.ny, 1)
    sgn = np.where(top, 1.0, -1.0)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt, device=device)
    live = np.ones(n, bool)
    return SpeciesState(
        dx=t(rng.uniform(-1, 1, n)), dy=t(sgn * rng.uniform(0.2, 1.0, n)),
        dz=t(rng.uniform(-1, 1, n)),
        i=t(x + g.NX * (y + g.NY), torch.int32),
        ux=t(rng.normal(0, 0.5, n)), uy=t(sgn * rng.uniform(2.0, 6.0, n)),
        uz=t(rng.normal(0, 0.5, n)), w=t(rng.uniform(0.5, 1.5, n)),
        live=t(live, torch.bool), np=t(n, torch.int32))


def test_kernel_wraps_across_periodic_faces(cuda):
    """Rounds after a wrap across the periodic y faces lie a whole domain
    away from the block's tile: they take the global path."""
    g = G.partition_periodic_box(0, 0, 0, 1, 1, 1, 32, 32, 1, cvac=1.0,
                                 eps0=1.0)
    g = G.Grid(**{**g.__dict__, "dt": 0.95 * g.courant_length()})
    rng = np.random.default_rng(9)
    fcoef = torch.tensor(rng.normal(0, 0.3, (g.nv, 18)), dtype=torch.float32,
                         device=cuda)
    species = [FP.bucket_sort_p(_wrap_lanes(g, 3000, cuda, seed), g)
               for seed in (1, 2)]
    ((sk, acc_k, unf_k), (sr, acc_r, unf_r)), (glob, every) = _counted_push(
        species, fcoef, g, [(-1.0, 1.0), (1.0, 1.5)])
    assert unf_k == unf_r
    _compare(sk, acc_k, sr, acc_r)
    wrapped = sum(int(((a.i // g.NX) % g.NY != (b.i // g.NX) % g.NY).sum())
                  for a, b in zip(sk, species))
    assert wrapped > 0 and 0 < glob < every


def test_wrapper_rejects_bad_inputs(cuda):
    g = G.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 1)
    sp = _hot(g, 100, cuda, seed=4)
    fcoef = torch.zeros((g.nv, 18), device=cuda)
    acc = torch.zeros((g.nv, 12), device=cuda)
    qms = [(1.0, 1.0)]
    with pytest.raises(TypeError):
        FP.fused_push_multi([sp.replace(i=sp.i.long())], fcoef, acc, g, qms)
    with pytest.raises(ValueError):
        FP.fused_push_multi([sp.replace(dx=sp.dx.repeat(2)[::2])], fcoef,
                            acc, g, qms)
    with pytest.raises(ValueError):
        FP.fused_push_multi([sp], fcoef, acc[:-1], g, qms)
    with pytest.raises(ValueError):
        FP.fused_push_multi([sp], fcoef, acc.cpu(), g, qms)


def test_harris_run_on_card_matches_cpu(cuda):
    p = harris.HarrisParams(nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        sim = harris.build(p, device=dev)
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
