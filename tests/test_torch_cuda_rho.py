"""The cleaners' charge deposit kernel (csrc/rho_p.cu, run by
ops/rho_p.accumulate_rho_multi on CUDA tensors) against its plain version
(ops/push.accumulate_rho_p per species) on the card: the TILE instance on
the 32^3 x 128 ppc residency layout with its home maps after a step and
after a rebucket, and on collisional reconnection's after a firing; the
global path on a 30 x 5 x 20 general-path sc08 deck and the 64^2 x 64 ppc
2-D deck; a layout whose lanes lie outside their block's brick; and a
cleaning step replayed from the step's CUDA graph against the eager step.

Tolerances, over the charge scale (the larger of max |rhof| and one
species' largest node charge): max abs err <= 2e-6 against the plain
version, and <= 1e-6 against the node form summed in float64
(scripts/rho_bench.exact), which the plain version itself misses by
1.4-2.0e-7 here.  The kernel adds in another order than the moment form,
with float atomics (the tile's shared-memory adds, its flush, the global
path) in an order that changes from run to run; the states here read up
to 8e-7 of the scale against the plain version and 7.5e-7 against the
float64 sum on an H100 (PERF.md §6).  initialize() keeps the plain
version: on its lanes, in no order, the global path reads ~3e-6 of the
scale against the float64 sum, ~17 times the plain version's error.  The
sums are each species' charge: ions and electrons loaded in pairs leave a
net charge below either's (a tenth to a half after a few steps, zero at
the start), so max |rhof| alone would hold the rounding of one order to
that of another (benchmark/check.py's ``rho_err`` floors its scale at one
species' charge density for the same reason).  Every test here is marked
``gpu`` and skips without a CUDA device (decided inside the fixture, never
at import).  This file imports neither jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_rho.py
"""

import pytest
import torch

from vpic_tpu_torch import step_graph as SG
from vpic_tpu_torch.models import sc08
from vpic_tpu_torch.ops import _build
from vpic_tpu_torch.ops import fused_push3d as FP3
from vpic_tpu_torch.ops import push as P
from vpic_tpu_torch.ops import residency as RES
from vpic_tpu_torch.ops import rho_p as RHO
from vpic_tpu_torch.scripts import graph_checks as GC
from vpic_tpu_torch.scripts import rho_bench as RB

pytestmark = pytest.mark.gpu

RTOL = 2e-6                 # against the plain version
EXACT_RTOL = 1e-6           # against the float64 node form
SMALL3D = dict(nx=16, ny=16, nz=16, nppc=8, Lx=8.0, Ly=8.0, Lz=8.0,
               headroom=6.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _homes(state):
    return [state.diag[f"_chart_home{k}"] for k in range(len(state.species))]


def _compare(sim, state, homes, exact=True):
    """(max abs err over the charge scale, [global-path lanes, live
    lanes]) of the kernel against the plain version on the state's lanes;
    with ``exact``, asserts the kernel within EXACT_RTOL of the float64
    node form."""
    g = sim.grid
    qs = [st.params.q for st in sim.species]
    dev = state.species[0].dx.device
    RHO.deposits = None
    n0 = RHO.launches
    got = RHO.accumulate_rho_multi(torch.zeros(g.nv, device=dev),
                                   state.species, qs, g, homes)
    assert RHO.launches == n0 + 1
    want = torch.zeros(g.nv, device=dev)
    for sp, q in zip(state.species, qs):
        P.accumulate_rho_p(want, sp, g, q)
    counts = RHO.deposits.tolist()
    live = sum(int(sp.live.sum()) for sp in state.species)
    assert counts[1] == live
    scale = _scale(sim, state, want)
    if exact:
        ref = RB.exact(state.species, qs, g)
        off = float((got.double() - ref).abs().max()) / scale
        assert off <= EXACT_RTOL, off
    return float((got - want).abs().max()) / scale, counts


def _scale(sim, state, rhof):
    """The charge scale: max |rhof| or one species' largest node charge."""
    g = sim.grid
    one = [P.accumulate_rho_p(torch.zeros_like(rhof), sp, g,
                              st.params.q).abs().max()
           for st, sp in zip(sim.species, state.species)]
    scale = float(torch.stack(one + [rhof.abs().max()]).max())
    assert scale > 0
    return scale


def _steps(sim, n):
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(n):
        state = step(state)
    return state, step


def test_kernel_builds_for_sm_90a_without_spills(cuda):
    _build.build_many([RHO.KERNEL])
    log = _build.build_log(RHO.KERNEL)
    spills = [ln for ln in log.splitlines() if "spill stores" in ln]
    assert "sm_90a" in log and spills
    assert all("0 bytes spill stores" in ln for ln in spills), spills


def test_tile_instance_on_the_residency_layout(cuda):
    sim = GC.build("harris3d", cuda)
    state, step = _steps(sim, 2)
    assert step.path == "push3d" and sim._residency_mode()[0]
    err, counts = _compare(sim, state, _homes(state))
    assert err <= RTOL and counts[0] == 0, (err, counts)
    # the layout a rebucket leaves: the residency sort of the extent slices
    g = sim.grid
    slack = sim._residency_mode()[1]
    bounds = sim._live_bounds()
    out = [FP3.brick_sort_p_res(RES.slice_species(sp, e), g, extent=b,
                                slack=slack)
           for sp, e, b in zip(state.species,
                               RES.extents(g, bounds, slack), bounds)]
    sorted_state = state.replace(species=tuple(o[0] for o in out))
    err, counts = _compare(sim, sorted_state, [o[1] for o in out])
    assert err <= RTOL and counts[0] == 0, (err, counts)


def test_tile_instance_after_a_collision_firing(cuda):
    sim = GC.build("reconnection", cuda)
    state, step = _steps(sim, 6)
    assert step.path == "push3d" and sim._residency_mode()[0]
    err, counts = _compare(sim, state, _homes(state))
    assert err <= RTOL and counts[0] == 0, (err, counts)


@pytest.mark.parametrize("deck", ["sc08", "harris2d"])
def test_global_path(cuda, deck):
    if deck == "sc08":
        sim = sc08.build(sc08.SC08Params(nx=30, ny=5, nz=20), device=cuda)
    else:
        sim = GC.build("harris2d", cuda)
    state, step = _steps(sim, 3)
    assert step.path == ("general" if deck == "sc08" else "push2d")
    err, counts = _compare(sim, state, None)
    assert err <= RTOL and counts[0] == counts[1], (err, counts)


def test_lanes_outside_their_brick_take_the_global_path(cuda):
    sim = GC.build("harris3d", cuda, **SMALL3D)
    state, _ = _steps(sim, 2)
    homes = _homes(state)
    base, counts = _compare(sim, state, homes)
    assert base <= RTOL and counts[0] == 0
    nb = (sim.grid.nx // 8) * (sim.grid.ny // 8) * (sim.grid.nz // 8)
    for wrong in ([torch.roll(h, 1) for h in homes],
                  [(h + 1) % nb for h in homes],
                  [torch.full_like(h, nb) for h in homes],
                  [h[: h.shape[0] // 2].contiguous() for h in homes]):
        # lanes in brick order, not voxel order, on the global path: held
        # to the plain version only
        err, counts = _compare(sim, state, wrong, exact=False)
        assert err <= RTOL and counts[0] > 0, (err, counts)


def test_graphed_cleaning_step_matches_eager(cuda):
    sim = GC.build("harris3d", cuda, **SMALL3D)
    sim.clean_div_e_interval = 4
    n0 = RHO.launches
    state = sim.initialize()
    assert RHO.launches == n0              # initialize() keeps the plain form
    step = sim.make_step()
    assert step.graphed is True
    SG.settle()
    n0 = RHO.launches
    for _ in range(20):
        state = step(state)
    SG.settle()
    assert RHO.launches - n0 == 5          # steps 0, 4, 8, 12, 16
    assert step.advance.cadence(state.step, state.diag).clean_e
    assert step.advance.cadence(state.step, state.diag) in step.graphs
    other = GC.clone_state(state)
    RHO.deposits = None
    n0 = RHO.launches
    out_g = step(state)
    SG.settle()
    assert RHO.launches == n0 + 1
    glob, live = RHO.deposits.tolist()
    assert glob == 0 and live == sum(int(sp.live.sum())
                                     for sp in out_g.species)
    out_e = sim.make_advance()(other)
    assert GC.lanes_equal(out_g, out_e) == []
    a, b = out_g.fields.rhof, out_e.fields.rhof
    assert float((a - b).abs().max()) <= RTOL * _scale(sim, out_e, b)
