"""The graphed step's stage maps on the card (utils/profile.py,
step_graph._Capture.stage), at small sizes:

* for each cadence graph of harris 2-D and 3-D, the map's records add up
  to the graph's kernel, memcpy and memset nodes (its IF bodies' too), and
  the graph has the nodes, kind for kind, of a capture with the stage
  bookkeeping stubbed out: the map adds nothing to the graph;
* a profiled window of replays is attributed with no unstaged record;
* the rebucket bodies the attribution finds in a traced window equal the
  window's ``diag["_res_rebuckets"]`` increment;
* in a profiled window of the collisional reconnection deck every firing
  replay, which opens with the generator's fills, is claimed whole, and
  the window's rebuckets by cause (``step_graph.rebucket_log``) add up to
  the rebuckets found.

Every test here is marked ``gpu`` and skips without a CUDA device
(decided inside the fixture, never at import).  This file imports neither
jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_stages.py
"""

import pytest
import torch

from vpic_tpu_torch import step_graph as SG
from vpic_tpu_torch.scripts import PROFILE_TRIES, profile_window
from vpic_tpu_torch.scripts import graph_checks as GC
from vpic_tpu_torch.utils import profile as PF

pytestmark = pytest.mark.gpu

SMALL = dict(
    harris2d=dict(nx=16, ny=16, nppc=16, Lx=8.0, Ly=8.0),
    harris3d=dict(nx=16, ny=16, nz=16, nppc=8, Lx=8.0, Ly=8.0, Lz=8.0,
                  headroom=6.0))


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


class _Listed:
    """The deck's step, listing every node of the main graph as each
    capture of it ends (``listed``: cadence -> kinds)."""

    def __init__(self, advance, nodes):
        self.advance, self.nodes = advance, nodes
        self.path, self.fields = advance.path, advance.fields
        self.cadence = advance.cadence
        self.capture = None
        self.listed = {}

    def __call__(self, state):
        self.advance.capture = self.capture
        try:
            out = self.advance(state)
        finally:
            self.advance.capture = None
        if self.capture is not None:
            stream = torch.cuda.current_stream().cuda_stream
            cad = self.cadence(state.step, state.diag)
            self.listed[cad] = self.nodes(stream, 0)[1]
        return out


class _Bodies:
    """graph_cond's library, listing each IF body's nodes as its capture
    ends (``bodies``)."""

    def __init__(self, lib, nodes):
        self.lib, self.nodes, self.bodies = lib, nodes, []

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def graph_if_end(self, body):
        self.bodies.append(self.nodes(body, 0)[1])
        return self.lib.graph_if_end(body)


def _captured(deck, cuda, monkeypatch, stub: bool, n: int = 24):
    """Every cadence of the deck's first steps captured: (the graphed
    step, its main graphs' node kinds by cadence, its IF bodies' kinds in
    capture order), with the stage bookkeeping stubbed out where ``stub``."""
    nodes, lib = SG._nodes, SG._lib()
    bodies = _Bodies(lib, nodes)
    with monkeypatch.context() as m:
        m.setattr(SG, "_lib", lambda: bodies)
        if stub:
            m.setattr(SG._Capture, "stage", lambda self, name: None)
            m.setattr(SG, "_nodes", lambda stream, start: (start, "", []))
        sim = GC.build(deck, cuda, **SMALL[deck])
        listed = _Listed(sim.make_advance(), nodes)
        step = SG.GraphedStep(sim, listed)
        GC.warm_for(step, sim.initialize(), n)
        torch.cuda.synchronize()
    return step, listed.listed, bodies.bodies


@pytest.mark.parametrize("deck", sorted(SMALL))
def test_maps_count_the_graph_nodes_and_add_none(cuda, deck, monkeypatch):
    step, listed, bodies = _captured(deck, cuda, monkeypatch, stub=False)
    _, bare, bare_bodies = _captured(deck, cuda, monkeypatch, stub=True)
    assert listed.keys() == step.graphs.keys() == bare.keys()
    assert len(listed) >= 2
    ifs = 0
    for cad, entry in step.graphs.items():
        kinds = listed[cad]
        assert kinds == bare[cad], cad
        main = [it for it in entry.stages if isinstance(it, PF.Run)]
        conds = [it for it in entry.stages if isinstance(it, PF.If)]
        assert sum(len(r.kinds) for r in main) == \
            sum(c in "kcs" for c in kinds)
        assert len(conds) == kinds.count("o")
        for it in conds:
            assert PF.records(it.body) == \
                sum(c in "kcs" for c in bodies[ifs])
            ifs += 1
        stages = [it.stage for it in entry.stages]
        assert stages == sorted(stages, key=PF.STAGES.index)
        anchors = {h for it in main for _, h in it.anchors}
        push = "fused_push2d_kernel" if deck == "harris2d" else \
            "fused_push3d_kernel"
        assert {push, "field_beb"} <= anchors
    assert bodies == bare_bodies and ifs == len(bodies)
    assert ifs == (0 if deck == "harris2d" else 2 * len(step.graphs))


def _device_records(prof):
    return sorted(((e.name, float(e.time_range.start),
                    float(e.time_range.end)) for e in prof.events()
                   if e.device_type.name == "CUDA"
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: r[1])


def _profiled(sim, state, n, prepare=None):
    """n replays of make_multi_step(n) under the profiler, after every
    cadence of them is captured: (the attribution, the state, the window's
    rebuckets).  A window whose records do not all fit (the profiler drops
    one now and then at a window's edge) is profiled again, up to
    PROFILE_TRIES."""
    many = sim.make_multi_step(n)
    state = GC.warm_for(many.step, state, n)
    for _ in range(PROFILE_TRIES):
        if prepare is not None:
            prepare(sim, state)
        r0 = int(state.diag.get("_res_rebuckets", torch.zeros(())))
        SG.replay_log.clear()
        with profile_window() as prof:
            state = many(state)
        r1 = int(state.diag.get("_res_rebuckets", torch.zeros(())))
        got = PF.attribute(_device_records(prof), SG.replay_log.maps)
        if not got.unstaged:
            break
    return got, state, r1 - r0


@pytest.mark.parametrize("deck", sorted(SMALL))
def test_a_profiled_window_is_attributed_whole(cuda, deck):
    sim = GC.build(deck, cuda, **SMALL[deck])
    n = 24
    got, _, rebuckets = _profiled(sim, sim.initialize(), n)
    assert got.unstaged == [] and got.replays == n and got.misfits == 0
    assert len(SG.replay_log.maps) == n
    # the carry is empty on these decks: every carried tensor is written
    # in place
    expect = {"load_interpolator", "advance_p", "unload_accumulator",
              "field_advance"}
    if deck == "harris3d":
        expect |= {"residency_plan", "residency_exchange"}
        assert got.taken.get("rebucket", 0) == rebuckets
        assert got.taken.get("merge", 0) == n - rebuckets
    assert expect <= set(got.stage_us)
    assert got.graph_gap_us >= 0 and got.launch_gap_us >= 0


def test_rebuckets_found_equal_the_counter(cuda):
    sim = GC.build("residency16", cuda)
    got, _, rebuckets = _profiled(sim, sim.initialize(), 6,
                                  prepare=GC.force_rebucket)
    assert got.unstaged == []
    assert rebuckets >= 1
    assert got.taken.get("rebucket", 0) == rebuckets
    assert got.taken.get("merge", 0) == 6 - rebuckets


def test_a_collisional_window_is_attributed_whole(cuda):
    """Every firing replay of the window, which opens with the generator's
    fills, is claimed whole; the window starts on a plain step, since the
    profiler may drop a few records of a window's first replay (then that
    replay alone misfits, as on the harris windows above)."""
    sim = GC.build("reconnection", cuda, nx=16, ny=16, nz=16, nppc=8,
                   Lx=8.0, Ly=8.0, Lz=8.0, headroom=6.0, tau_coll_interval=2)
    n = 24
    many = sim.make_multi_step(n)
    state = GC.warm_for(many.step, sim.initialize(), n + 1)
    if state.step % 2 == 0:
        state = many.step(state)
    r0 = int(state.diag["_res_rebuckets"])
    SG.replay_log.clear()
    with profile_window() as prof:
        state = many(state)
    rebuckets = int(state.diag["_res_rebuckets"]) - r0
    got = PF.attribute(_device_records(prof), SG.replay_log.maps)
    assert got.stage_replays["collision"] == n // 2
    assert got.misfits <= 1 and got.replays == n - got.misfits
    assert {"collision", "sort_p", "residency_exchange"} <= set(got.stage_us)
    assert sum(SG.rebucket_log.counts().values()) == rebuckets
