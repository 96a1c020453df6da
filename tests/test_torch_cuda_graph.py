"""The graphed step (step_graph) on the card against the eager step, at
small sizes (chip_smoke.py phase 29 runs the main path's sizes): one step
graphed and one eager from one state (lanes bit for bit, equal generator
states) and ten steps each way (fields to 5e-7 + 1e-5 max|a|,
tests/test_pallas.py:88-94) on 2-D harris, 3-D residency harris, the
emission diode and collisional reconnection; a rebucket forced under the IF
node, equal to the eager branch; make_multi_step under torch's sync debug
mode "error"; and the replay accounting against the profiler's kernel
counts.  Every test here is marked ``gpu`` and skips without a CUDA device
(decided inside the fixture, never at import).  This file imports neither
jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_graph.py
"""

import warnings

import pytest
import torch

import vpic_tpu_torch.ops.field_fuse as FF
import vpic_tpu_torch.ops.fused_push as FP
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.residency as RES
from vpic_tpu_torch import step_graph as SG
from vpic_tpu_torch.scripts import PROFILE_TRIES, profile_window
from vpic_tpu_torch.scripts import graph_checks as GC

pytestmark = pytest.mark.gpu

SMALL = dict(
    harris2d=dict(nx=16, ny=16, nppc=16, Lx=8.0, Ly=8.0),
    harris3d=dict(nx=16, ny=16, nz=16, nppc=8, Lx=8.0, Ly=8.0, Lz=8.0,
                  headroom=6.0),
    emission=dict(nx=16, ny=4, Lx=0.5, Ly=0.125),
    reconnection=dict(nx=16, ny=16, nz=16, nppc=8, Lx=8.0, Ly=8.0, Lz=8.0,
                      headroom=6.0, tau_coll_interval=3))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("deck", sorted(SMALL))
def test_graphed_step_matches_eager(cuda, deck):
    sim = GC.build(deck, cuda, **SMALL[deck])
    assert sim.make_step().graphed is True
    if deck in ("harris3d", "reconnection"):
        assert sim._residency_mode()[0]
    res = GC.graphed_vs_eager(sim, sim.initialize(), 10)
    assert res["lanes"] == [], res
    assert res["fields"] < 1.0, res
    assert res["rebuckets"][0] == res["rebuckets"][1]


def test_forced_rebucket_under_the_if_node(cuda):
    sim = GC.build("residency16", cuda)
    assert sim._residency_mode() == (True, 1)
    res = GC.graphed_vs_eager(sim, sim.initialize(), 3,
                              prepare=GC.force_rebucket)
    assert res["rebuckets"] == (1, 1) and res["lanes"] == [], res
    assert res["fields"] < 1.0, res


def _window(sim, state, n):
    """make_multi_step(n) after the cadences of the next n steps are
    captured, under sync debug mode "error"; returns the state and the
    counts of the window (settled)."""
    many = sim.make_multi_step(n)
    state = GC.warm_for(many.step, state, n)    # warm-ups and captures
    SG.settle()
    torch.cuda.synchronize()
    SG.launches = FP.launches = FP3.launches = RES.launches = 0
    FF.launches = 0
    sim.host_syncs = 0
    r0 = int(state.diag.get("_res_rebuckets", torch.zeros(())))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("error")
        try:
            state = many(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert many.step.eager_steps == len(many.step.warm)
    SG.settle()
    r1 = int(state.diag.get("_res_rebuckets", torch.zeros(())))
    return state, r1 - r0


@pytest.mark.parametrize("deck", ["harris2d", "harris3d"])
def test_multi_step_makes_no_sync_and_counts_launches(cuda, deck):
    sim = GC.build(deck, cuda, **SMALL[deck])
    n = 24
    state, rebuckets = _window(sim, sim.initialize(), n)
    assert sim.host_syncs == 0
    assert FF.launches == n
    if deck == "harris2d":
        assert FP.launches == n and SG.launches == 0
    else:
        assert FP3.launches == n and RES.launches == n - rebuckets
        # two IF nodes a replay, each behind its condition kernel
        assert SG.launches == 2 * n
    assert int(state.diag["unfinished"]) == 0


def test_replay_counts_match_the_profiler(cuda):
    """The replay accounting against the kernels the profiler saw in the
    window: the push, field_beb, the merge and the condition kernels.  The
    profiler now and then drops device records (one window of the suite
    saw 10 of 12 merges; 60 windows alone saw every one), so a window
    that disagrees is profiled again, up to PROFILE_TRIES, as
    scripts.device_kernels does; each window's own counts are compared."""
    sim = GC.build("harris3d", cuda, **SMALL["harris3d"])
    n = 12
    many = sim.make_multi_step(n)
    state = GC.warm_for(many.step, sim.initialize(), n)
    names = ("fused_push3d_kernel", "field_beb_grid_kernel", "merge_kernel",
             "set_condition_kernel")
    for _ in range(PROFILE_TRIES):
        SG.settle()
        torch.cuda.synchronize()
        SG.launches = FP3.launches = RES.launches = FF.launches = 0
        with profile_window() as prof:
            state = many(state)
        SG.settle()
        seen = dict.fromkeys(names, 0)
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                for name in names:
                    if name in e.key:
                        seen[name] += e.count
        counted = dict(zip(names, (FP3.launches, FF.launches, RES.launches,
                                   SG.launches)))
        calls = GC.host_launches(prof)
        if seen == counted:
            break
    assert seen == counted, (seen, counted)
    assert FP3.launches == FF.launches == n and SG.launches == 2 * n
    assert RES.launches <= n
    assert calls == {"kernel": 0, "graph": n}, calls


def test_refused_decks_say_why(cuda):
    refused = {k: v for k, v in GC.refusals().items() if v}
    assert set(refused) == {"lpi", "dipole", "waveguide", "cygnus"}, refused
    assert all("takes the host step" in v for v in refused.values())
