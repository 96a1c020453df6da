"""The step's stages (utils/profile.py) on the CPU.

* ``attribute`` lays stage maps (utils.profile.Run and If, as a capture
  writes them) over synthetic device records: replays that merge and
  rebucket under the two IF nodes of the residency step, a record the
  profiler dropped and a wrong anchor (that replay's records go to
  unstaged and the next replay is attributed again), the idle inside and
  between replays, and a Chrome trace's stage track.
* On an eager harris 2-D and 3-D step under the CPU profiler every
  top-level aten op lies inside exactly one ``vpic.<stage>`` range, and the
  ranges come in the order of utils.profile.STAGES.
* Replays of the collisional deck's graphed step recorded on the card
  (tests/data/collision_replays.json): PyTorch fills the generator's seed
  and offset before it launches a graph that draws, so a firing replay's
  capture map misfits its records, and its replay map
  (``utils.profile.replayed``) claims them all, also where a record of
  the window's first replay was dropped; the graphed step's warm-up finds
  the stage that draws.
* With no profiler the stage marker and the graphed step's replay logging
  open no record_function range and log nothing; under one they do.
* scripts.device_averages leaves the ranges' device-side shadows out of
  the port's device-time sums.

The graphs themselves are checked on the card
(tests/test_torch_cuda_stages.py)."""

import json
import os
import types

import pytest
import torch

from vpic_tpu_torch import step_graph as SG
from vpic_tpu_torch.models import harris, reconnection
from vpic_tpu_torch.scripts import device_averages
from vpic_tpu_torch.state import SimState
from vpic_tpu_torch.utils import profile as PF

torch.set_num_threads(2)

Run, If = PF.Run, PF.If
COND = "set_condition_kernel"
# a residency step's map: the push among plain kernels, the plan, the two
# IF nodes (the rebucket's body has no hand kernel, the merge's has the
# merge), the unload, field_beb, a copy in the carry
MAP = (
    Run("load_interpolator", "kk", ()),
    Run("advance_p", "kkk", ((1, "fused_push3d_kernel"),)),
    Run("residency_plan", "kkk", ()),
    Run("residency_exchange", "k", ((0, COND),)),
    If("residency_exchange", "rebucket", (
        Run("residency_exchange", "kksk", ()),)),
    Run("residency_exchange", "kk", ((1, COND),)),
    If("residency_exchange", "merge", (
        Run("residency_exchange", "kcck", ((1, "merge_kernel"),)),)),
    Run("unload_accumulator", "kk", ()),
    Run("field_advance", "k", ((0, "field_beb"),)),
    Run("carry", "c", ()),
)
NAMES = {"fused_push3d_kernel": "fused_push3d_kernel(Push3dArgs)",
         "merge_kernel": "(anonymous namespace)::merge_kernel(MergeArgs)",
         COND: "(anonymous namespace)::set_condition_kernel(...)",
         "field_beb": "field_beb_grid_kernel(BebArgs)"}


def _replay(stage_map, taken, t0):
    """The records one replay of ``stage_map`` leaves from t0, each 1 us
    long with a 1 us gap, the IF bodies of the branches in ``taken`` run;
    also the stage of each record."""
    recs, stages = [], []
    for it in stage_map:
        if isinstance(it, If):
            if it.branch in taken:
                r, s = _replay(it.body, taken, t0)
                recs += r
                stages += s
                t0 = recs[-1][2] + 1.0
            continue
        anchors = dict(it.anchors)
        for j, kind in enumerate(it.kinds):
            name = (NAMES[anchors[j]] if j in anchors else
                    "Memcpy DtoD (Device -> Device)" if kind == "c" else
                    "Memset (Device)" if kind == "s" else
                    f"void at::native::elementwise_kernel<{len(recs)}>")
            recs.append((name, t0, t0 + 1.0))
            stages.append(it.stage)
            t0 += 2.0
    return recs, stages


def _window(branches, gap=10.0):
    recs, stages, t = [], [], 0.0
    for taken in branches:
        r, s = _replay(MAP, taken, t)
        recs += r
        stages += s
        t = recs[-1][2] + gap
    return recs, stages


def _expected_us(stages):
    out = {}
    for s in stages:
        out[s] = out.get(s, 0.0) + 1.0
    return out


def test_replays_that_merge_and_rebucket():
    branches = [{"merge"}, {"rebucket"}, {"merge"}, {"merge"}]
    recs, stages = _window(branches)
    got = PF.attribute(recs, [MAP] * 4)
    assert got.replays == 4 and got.misfits == 0 and got.unstaged == []
    assert got.taken == {"merge": 3, "rebucket": 1}
    assert got.stage_us == _expected_us(stages)
    assert [s[0] for s in got.spans[:7]] == [
        "load_interpolator", "advance_p", "residency_plan",
        "residency_exchange", "unload_accumulator", "field_advance", "carry"]
    # inside a replay each record is followed by 1 us of idle but the last
    n = [len(_replay(MAP, b, 0.0)[0]) for b in branches]
    assert got.graph_gap_us == pytest.approx(sum(k - 1 for k in n))
    assert got.launch_gap_us == pytest.approx(3 * 10.0)
    assert PF.records(MAP) == len(_replay(MAP, {"merge", "rebucket"},
                                          0.0)[0])


def test_a_cut_between_replays_is_not_launch_idle():
    recs, _ = _window([{"merge"}] * 3)
    first_end = _replay(MAP, {"merge"}, 0.0)[0][-1][2]
    got = PF.attribute(recs, [MAP] * 3, cuts=[(first_end + 2.0,
                                                first_end + 3.0)])
    assert got.launch_gap_us == pytest.approx(10.0)


@pytest.mark.parametrize("fault", ["dropped", "wrong_anchor"])
def test_a_misfit_replay_goes_to_unstaged(fault):
    recs, stages = _window([{"merge"}] * 4)
    per = len(recs) // 4
    bad = list(range(per, 2 * per))
    if fault == "dropped":
        # the profiler lost the second replay's third record
        del recs[per + 2]
        bad = bad[:-1]
    else:
        # a merge kernel where the second replay's map has its push
        name, a, b = recs[per + 3]
        assert "fused_push3d_kernel" in name
        recs[per + 3] = (NAMES["merge_kernel"], a, b)
    got = PF.attribute(recs, [MAP] * 4)
    assert got.replays == 3 and got.misfits == 1
    assert got.unstaged == [recs[j] for j in bad]
    kept = stages[:per] + stages[2 * per:]
    assert got.stage_us == _expected_us(kept)
    assert got.taken == {"merge": 3}
    # only the idle between the two replays that follow each other counts
    assert got.launch_gap_us == pytest.approx(10.0)


def test_records_before_the_first_replay_are_unstaged():
    recs, stages = _window([{"rebucket"}, {"merge"}])
    junk = [("void at::native::fill_kernel", -10.0, -9.0)]
    got = PF.attribute(junk + recs, [MAP] * 2)
    assert got.unstaged == junk and got.replays == 2
    assert got.stage_us == _expected_us(stages)


REPLAYS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "collision_replays.json")


def _decoded(m) -> tuple:
    return tuple(Run(it[1], it[2], tuple(tuple(a) for a in it[3]))
                 if it[0] == "R" else If(it[1], it[2], _decoded(it[3]))
                 for it in m)


def _replays(deck):
    """(records, capture maps, the fixture's entry) of one deck."""
    with open(REPLAYS) as fh:
        d = json.load(fh)["decks"][deck]
    recs = [(d["names"][k], s, e) for k, s, e in d["records"]]
    return recs, [_decoded(m) for m in d["maps"]], d


@pytest.mark.parametrize("deck", ["general 8^3", "residency 16^3"])
def test_a_firing_replay_is_attributed_whole(deck):
    recs, maps, d = _replays(deck)
    # plain, firing, plain: the firing replay's capture map misfits
    assert [d["drew"][k] for k in d["replays"]] == [None, "collision", None]
    captured = PF.attribute(recs, [maps[k] for k in d["replays"]])
    assert captured.misfits >= 1 and captured.unstaged
    got = PF.attribute(recs, [PF.replayed(maps[k], d["drew"][k])
                              for k in d["replays"]])
    assert got.replays == 3 and got.misfits == 0 and got.unstaged == []
    assert got.stage_replays["collision"] == 1
    assert sum(got.stage_us.values()) == pytest.approx(
        sum(e - s for _, s, e in recs))
    # the generator's two fills open the firing replay, in its collision
    first = PF._Window(recs).walk(maps[d["replays"][0]], 0)[0]
    fills = recs[first:first + len(PF.GENERATOR_PROLOGUE)]
    assert all("FillFunctor<long>" in n for n, _, _ in fills)
    assert ("collision", fills[0][1], fills[-1][2]) in got.spans
    if deck.startswith("residency"):
        assert {"sort_p", "residency_exchange"} <= set(got.stage_us)


@pytest.mark.parametrize("deck", ["general 8^3", "residency 16^3"])
@pytest.mark.parametrize("where", ["first", "last"])
def test_a_record_dropped_from_the_first_replay_costs_it_alone(deck, where):
    """The profiler drops a record of a window's first replay (plain): that
    replay misfits, and the firing replay after it, whose map the plain
    one's would also fit over its tail, is still claimed whole."""
    recs, maps, d = _replays(deck)
    log = [PF.replayed(maps[k], d["drew"][k]) for k in d["replays"]]
    first = PF._Window(recs).walk(log[0], 0)[0]
    drop = 0 if where == "first" else first - 1
    recs = recs[:drop] + recs[drop + 1:]
    got = PF.attribute(recs, log)
    assert got.misfits == 1 and got.replays == 2
    assert got.stage_replays["collision"] == 1
    assert got.unstaged == recs[:first - 1]


def test_the_warm_up_finds_the_stage_that_draws():
    sim = reconnection.build(reconnection.ReconnectionParams(
        nx=8, ny=8, nz=8, nppc=8, Lx=8.0, Ly=8.0, Lz=8.0,
        tau_coll_interval=2), device="cpu")
    state = sim.initialize()
    gs = SG.GraphedStep.__new__(SG.GraphedStep)
    gs.sim, gs.advance = sim, sim.make_advance()
    gs.warm, gs.eager_steps = {}, 0
    drew = []
    for _ in range(2):
        cad = gs.advance.cadence(state.step, state.diag)
        state = gs._warm_up(state, cad)
        drew.append(gs.warm[cad])
    assert drew == ["collision", None]
    assert gs.advance.observe is None


def test_run_of_drops_nodes_without_records_and_finds_anchors():
    names = ["_ZN2at6native29vectorized_elementwise_kernelILi4E", "",
             "_ZN48_GLOBAL__N__b33698a7_15_fused_push3d_cu_02930bbc19"
             "fused_push3d_kernelE10Push3dArgs", "", ""]
    run = PF.run_of("advance_p", "kokcs", names)
    assert run == Run("advance_p", "kkcs", ((1, "fused_push3d_kernel"),))
    assert PF.run_of("carry", "oo", ["", ""]) is None


def test_stage_track_of_a_chrome_trace():
    recs, _ = _window([{"merge"}, {"rebucket"}])
    events = [{"ph": "X", "cat": "kernel", "name": n, "pid": 0, "tid": 7,
               "ts": a, "dur": b - a} for n, a, b in recs]
    events.append({"ph": "X", "cat": "cpu_op", "name": "aten::add",
                   "pid": 1, "tid": 1, "ts": 0.0, "dur": 5.0})
    track = PF.stage_track(events, [MAP] * 2)
    spans = [e for e in track if e["ph"] == "X"]
    assert {e["tid"] for e in track} == {PF.STAGE_TID}
    assert all(e["pid"] == 0 for e in track)
    assert [e["name"] for e in spans][:4] == [
        "load_interpolator", "advance_p", "residency_plan",
        "residency_exchange"]
    assert len(spans) == 2 * 7
    assert PF.stage_track(events, []) == []


# the eager step

H2 = dict(nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0)
H3 = dict(nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0, headroom=3.0)


@pytest.mark.parametrize("deck", ["harris2d", "harris3d"])
def test_every_top_level_op_lies_in_one_stage(deck):
    params = H2 if deck == "harris2d" else H3
    sim = harris.build(harris.HarrisParams(**params), device="cpu")
    advance = sim.make_advance()
    state = sim.initialize()
    # step 0: the sort or relayout and the cleaners run too
    assert advance.cadence(0, state.diag).clean_e
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        advance(state)
    events = prof.events()
    ranges = sorted((e for e in events if e.name.startswith(PF.PREFIX)),
                    key=lambda e: e.time_range.start)
    order = [e.name[len(PF.PREFIX):] for e in ranges]
    expect = ["load_interpolator", "sort_p", "advance_p",
              "unload_accumulator", "field_advance", "clean_div", "carry"]
    if deck == "harris3d":
        expect[3:3] = ["residency_plan", "residency_exchange"]
    assert order == expect
    assert order == sorted(order, key=PF.STAGES.index)
    top = 0
    for e in events:
        if not e.name.startswith("aten::") or (
                e.cpu_parent is not None
                and e.cpu_parent.name.startswith("aten::")):
            continue
        top += 1
        chain, p = [], e.cpu_parent
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        assert sum(n.startswith(PF.PREFIX) for n in chain) == 1, \
            (e.name, chain)
    assert top > 100


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _fake_graphed_step():
    """A GraphedStep whose one cadence is captured as a graph that does
    nothing, with MAP as its stage map."""
    cad = "plain"
    gs = SG.GraphedStep.__new__(SG.GraphedStep)
    gs.sim = types.SimpleNamespace(relayouts=0)
    gs.advance = types.SimpleNamespace(cadence=lambda step, diag: cad)
    gs.state = None
    gs.warm = {cad: False}
    graph = _FakeGraph()
    gs.graphs = {cad: SG._Graph(graph, [0] * (len(SG.COUNTERS) + 1), {},
                                None, {}, {}, MAP, "plain")}
    return gs, graph


class _Spy:
    """record_function, counting the ranges it opens."""

    def __init__(self, real):
        self.real, self.names = real, []

    def __call__(self, name, *a, **kw):
        self.names.append(name)
        return self.real(name, *a, **kw)


@pytest.fixture
def spy(monkeypatch):
    s = _Spy(torch.autograd.profiler.record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", s)
    return s


def test_no_profiler_no_ranges_and_no_log(spy):
    assert not PF.profiling()
    sim = harris.build(harris.HarrisParams(**H2), device="cpu")
    state = sim.initialize()
    sim.make_advance()(state)
    SG.replay_log.clear()
    gs, graph = _fake_graphed_step()
    out = gs.run(SimState(fields=None, species=(), step=0, diag={}, rng=None),
                 5)
    assert out.step == 5 and graph.replays == 5
    assert spy.names == [] and SG.replay_log.maps == []
    assert PF.marks(None) is PF._no_mark


def test_profiled_replays_are_logged_and_named(spy):
    gs, graph = _fake_graphed_step()
    state = SimState(fields=None, species=(), step=0, diag={}, rng=None)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        state = gs.run(state, 3)
    assert spy.names == ["vpic.chunk"] + ["vpic.replay/plain"] * 3
    assert SG.replay_log.maps == [MAP] * 3
    # unprofiled replays keep the log; the next profiled one starts anew
    state = gs.run(state, 2)
    assert SG.replay_log.maps == [MAP] * 3
    with torch.profiler.profile(activities=acts):
        gs.run(state, 1)
    assert SG.replay_log.maps == [MAP] and graph.replays == 6
    SG.replay_log.clear()


def test_cadence_labels():
    sim = harris.build(harris.HarrisParams(**H3), device="cpu")
    cad = sim.make_advance().cadence
    diag = {"_res_valid": True}
    assert SG.label(cad(1, diag)) == "plain"
    assert SG.label(cad(0, {"_res_valid": False})) == \
        "relayout+clean_e+clean_b+sync"


def test_device_averages_leave_annotations_out():
    dev = types.SimpleNamespace(name="CUDA")
    cpu = types.SimpleNamespace(name="CPU")

    def ev(key, device, t, annotation=False):
        return types.SimpleNamespace(key=key, device_type=device,
                                     device_time_total=t, count=1,
                                     is_user_annotation=annotation)

    events = [ev("fused_push2d_kernel", dev, 40.0),
              ev("vpic.advance_p", dev, 45.0, annotation=True),
              ev("vpic.replay/plain", dev, 270.0, annotation=True),
              ev("aten::add_", cpu, 12.0),
              ev("Memcpy DtoD (Device -> Device)", dev, 3.0),
              ev("idle", dev, 0.0)]
    prof = types.SimpleNamespace(key_averages=lambda: events)
    assert [e.key for e in device_averages(prof)] == [
        "fused_push2d_kernel", "Memcpy DtoD (Device -> Device)"]
