"""The cleaners' charge deposit (ops/rho_p) on the CPU: the wrapper is the
plain version there (``accumulate_rho_p`` per species, bit for bit); a
node-form emulation of the kernel's per-lane arithmetic (each live lane's
8 weights ((q * hx) * hy) * hz added to its voxel's nodes, a node past the
mesh dropped on its axis) matches the moment form to 1e-6 of max |rhof| on
2-D and 3-D grids, with lanes in edge and ghost voxels, dead slots and
zero weights (the two sum in another order: 1e-6 is ~8 float32 ulps of the
largest node); the wrapper refuses wrong dtypes, shapes, devices and home
maps; the launch plan deals every species' CUDA blocks round-robin and
serves each layout block once; and a CPU deck's cleaning step leaves rhof
as the plain deposit of its lanes, bit for bit.  The kernel itself is held against the plain
version on the card (tests/test_torch_cuda_rho.py)."""

import numpy as np
import pytest
import torch

from vpic_tpu_torch.grid import Grid
from vpic_tpu_torch.models import harris
from vpic_tpu_torch.ops import fields as F
from vpic_tpu_torch.ops import push as P
from vpic_tpu_torch.ops import rho_p as RHO
from vpic_tpu_torch.state import SpeciesState

torch.set_num_threads(2)

NODE_RTOL = 1e-6


def _species(g: Grid, n: int, seed: int, edges: bool = True):
    """n slots: random interior voxels and offsets, a fifth of the slots
    dead, some zero weights; with ``edges`` the first live lanes sit in
    the interior's corner and edge voxels and in the high ghost layer."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, g.nx + 1, n)
    y = rng.integers(1, g.ny + 1, n)
    z = rng.integers(1, g.nz + 1, n)
    if edges:
        corners = [(cx, cy, cz) for cx in (1, g.nx, g.nx + 1)
                   for cy in (1, g.ny, g.ny + 1)
                   for cz in (1, g.nz, g.nz + 1)]
        for k, (cx, cy, cz) in enumerate(corners):
            x[k], y[k], z[k] = cx, cy, cz
    i = x + g.NX * (y + g.NY * z)
    live = rng.random(n) > 0.2
    if edges:
        live[:27] = True
    w = rng.uniform(0.5, 2.0, n)
    w[rng.random(n) < 0.05] = 0.0
    off = rng.uniform(-1.0, 1.0, (3, n))
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    zero = torch.zeros(n, dtype=torch.float32)
    return SpeciesState(
        dx=f32(off[0]), dy=f32(off[1]), dz=f32(off[2]),
        i=torch.from_numpy(i.astype(np.int32)), ux=zero.clone(),
        uy=zero.clone(), uz=zero.clone(), w=f32(w),
        live=torch.from_numpy(live), np=torch.tensor(int(live.sum())))


def _node_form(g: Grid, species, qs):
    """The kernel's per-lane arithmetic in torch: each live lane adds
    ((q * hx) * hy) * hz, h = 1 -+ d, to node j = a + 2b + 4c of its voxel
    at i + a + sy b + sz c, unless x + a, y + b or z + c is past the mesh."""
    rho = torch.zeros(g.nv, dtype=torch.float32)
    for sp, qsp in zip(species, qs):
        q = torch.tensor(qsp * g.r8V, dtype=torch.float32) * sp.w
        i = sp.i.long()
        z, r = i // g.sz, i % g.sz
        y, x = r // g.sy, r % g.sy
        hx = (1.0 - sp.dx, 1.0 + sp.dx)
        hy = (1.0 - sp.dy, 1.0 + sp.dy)
        hz = (1.0 - sp.dz, 1.0 + sp.dz)
        for j in range(8):
            a, b, c = j & 1, (j >> 1) & 1, j >> 2
            wt = ((q * hx[a]) * hy[b]) * hz[c]
            keep = sp.live & (x + a < g.NX) & (y + b < g.NY) & (z + c < g.NZ)
            node = i + a + g.sy * b + g.sz * c
            rho.index_add_(0, node[keep], wt[keep])
    return rho


def _plain(g: Grid, species, qs):
    rho = torch.zeros(g.nv, dtype=torch.float32)
    for sp, q in zip(species, qs):
        P.accumulate_rho_p(rho, sp, g, q)
    return rho


GRIDS = {"2d": Grid(nx=12, ny=10, nz=1), "3d": Grid(nx=16, ny=8, nz=8),
         "3d_odd": Grid(nx=7, ny=5, nz=6)}
QS = (-1.0, 1.0, 0.25)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_wrapper_is_the_plain_version_on_the_cpu(name):
    g = GRIDS[name]
    species = [_species(g, 3000 + 7 * k, k) for k in range(len(QS))]
    homes = None
    if name == "3d":
        homes = [torch.zeros(-(-sp.capacity // RHO.LANES), dtype=torch.int32)
                 for sp in species]
    rho = torch.full((g.nv,), 0.5, dtype=torch.float32)
    out = RHO.accumulate_rho_multi(rho, species, QS, g, homes)
    assert out is rho
    want = torch.full((g.nv,), 0.5, dtype=torch.float32)
    for sp, q in zip(species, QS):
        P.accumulate_rho_p(want, sp, g, q)
    assert torch.equal(rho.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_node_form_matches_the_moment_form(name):
    g = GRIDS[name]
    species = [_species(g, 4000, 10 + k) for k in range(len(QS))]
    want = _plain(g, species, QS)
    got = _node_form(g, species, QS)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= NODE_RTOL * scale


def test_dead_slots_and_zero_weights_add_nothing():
    g = GRIDS["3d"]
    sp = _species(g, 2000, 3, edges=False)
    gone = sp.replace(live=torch.zeros_like(sp.live))
    rho = RHO.accumulate_rho_multi(torch.zeros(g.nv), [gone], [1.0], g)
    assert not rho.any()
    light = sp.replace(w=torch.zeros_like(sp.w))
    assert not _node_form(g, [light], [1.0]).any()
    # interior lanes: the charge sums to 8 q a lane (the weights' sum)
    total = float(_node_form(g, [sp], [1.0]).double().sum())
    want = float((sp.w.double() * sp.live).sum()) * 8 * g.r8V
    assert total == pytest.approx(want, rel=1e-5)


def _refused(exc, match, **kw):
    g = GRIDS["3d"]
    species = [_species(g, 2048, 0, edges=False)]
    args = dict(rhof_flat=torch.zeros(g.nv), species=species, qs=[1.0], g=g)
    args.update(kw)
    with pytest.raises(exc, match=match):
        RHO.accumulate_rho_multi(**args)


def test_wrapper_refuses_wrong_arguments():
    g = GRIDS["3d"]
    sp = _species(g, 2048, 0, edges=False)
    _refused(TypeError, "rhof has dtype",
             rhof_flat=torch.zeros(g.nv, dtype=torch.float64))
    _refused(ValueError, "rhof has shape", rhof_flat=torch.zeros(g.nv - 1))
    _refused(TypeError, r"species\[0\].dx has dtype",
             species=[sp.replace(dx=sp.dx.double())])
    _refused(TypeError, r"species\[0\].i has dtype",
             species=[sp.replace(i=sp.i.long())])
    _refused(ValueError, r"species\[0\].w has shape",
             species=[sp.replace(w=sp.w[:-1])])
    _refused(ValueError, r"species\[0\].live is on meta",
             species=[sp.replace(live=sp.live.to("meta"))])
    _refused(ValueError, r"species\[0\].dy is not contiguous",
             species=[sp.replace(dy=torch.stack([sp.dy, sp.dx], 1)[:, 0])])
    _refused(ValueError, "unsupported device",
             rhof_flat=torch.zeros(g.nv, device="meta"))
    _refused(ValueError, "one charge per species", qs=[1.0, 2.0])
    _refused(ValueError, "one home map per species", homes=[])
    _refused(TypeError, r"homes\[0\] has dtype",
             homes=[torch.zeros(2, dtype=torch.int64)])
    _refused(ValueError, r"homes\[0\] has shape",
             homes=[torch.zeros(3, dtype=torch.int32)])
    g2 = GRIDS["3d_odd"]
    with pytest.raises(ValueError, match="home maps need"):
        RHO.accumulate_rho_multi(
            torch.zeros(g2.nv), [_species(g2, 1024, 0, edges=False)], [1.0],
            g2, homes=[torch.zeros(1, dtype=torch.int32)])


def _served(nblocks, run):
    """The layout blocks each CUDA block of ``interleave_plan``'s launch
    serves, as csrc/rho_p.cu's species_of_block maps them."""
    head, blk0, grid = RHO.interleave_plan(nblocks, run)
    nsp = len(nblocks)
    out = []
    for b in range(grid):
        if b < nsp * head:
            s, local = b % nsp, b // nsp
        else:
            s = 0
            while s + 1 < nsp and b >= blk0[s + 1]:
                s += 1
            local = head + b - blk0[s]
        out.append((s, range(local * run, min(local * run + run,
                                              nblocks[s]))))
    return head, out


@pytest.mark.parametrize("nblocks,run", [([192, 192], 1), ([2304, 2304], 3),
                                         ([5, 3], 2), ([3, 5], 1),
                                         ([5, 3, 5], 1), ([7], 4)])
def test_launch_plan_deals_the_species_round_robin(nblocks, run):
    head, served = _served(nblocks, run)
    nsp = len(nblocks)
    assert head == min(-(-nb // run) for nb in nblocks)
    assert [s for s, _ in served[:nsp * head]] == list(range(nsp)) * head
    for k, nb in enumerate(nblocks):
        got = sorted(b for s, r in served if s == k for b in r)
        assert got == list(range(nb))
    assert all(len(r) for _, r in served)


DECKS = {"2d": dict(nx=16, ny=16, nppc=8, Lx=8.0, Ly=8.0),
         "3d": dict(nx=16, ny=16, nz=16, nppc=2, Lx=8.0, Ly=8.0, Lz=8.0,
                    headroom=6.0)}


@pytest.mark.parametrize("name", sorted(DECKS))
def test_cleaning_step_on_a_cpu_deck_is_the_plain_deposit(name):
    sim = harris.build(harris.HarrisParams(**DECKS[name]), device="cpu")
    state = sim.initialize()
    step = sim.make_step()
    assert step.path == ("push2d" if name == "2d" else "push3d")
    assert step.cadence(state.step, state.diag).clean_e
    launches = RHO.launches
    out = step(state)
    assert RHO.launches == launches    # no kernel on the CPU
    g = sim.grid
    f = out.fields.replace(rhof=torch.zeros_like(out.fields.rhof),
                           rhob=out.fields.rhob.clone())
    for st, sp in zip(sim.species, out.species):
        P.accumulate_rho_p(f.rhof.view(-1), sp, g, st.params.q)
    F.synchronize_rho(f, g)
    assert torch.equal(out.fields.rhof.view(torch.int32),
                       f.rhof.view(torch.int32))
