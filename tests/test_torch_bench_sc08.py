"""The benchmark's SC08 one-triblade demo cell (``sc08.150x25x100.1ppc``)
on the CPU:

* the cell resolves: its configuration, traffic, limits, per-layer
  metrics and plain reference (``benchmark/reference/sc08.py``), which
  loads nothing of the program; the configuration's cut is its
  ``reduced``;
* the published 150 x 25 x 100 grid is one the 8^3 bricks do not tile, and
  a small non-tiled sc08 deck takes the general path;
* the reference's load and initial state are the port's, lane by lane and
  field by field, at that small size;
* that deck, with a repeat that crosses a sort and cleaning step, runs
  correct through the harness's own ``core.run_cell``, and the bfloat16
  control is not correct;
* the three per-layer readers read nothing without a timeline and the
  hand-reckoned share on a hand-made one."""

import subprocess
import sys

import pytest
import torch

from benchmark import check, core, trace
from benchmark.reference import pic
from benchmark.reference import sc08 as ref
from vpic_tpu_torch import grid as G
from vpic_tpu_torch.models import sc08
from vpic_tpu_torch.ops import fused_push3d as FP3
from vpic_tpu_torch.state import FIELD_NAMES

torch.set_num_threads(2)

CELL = "sc08.150x25x100.1ppc"
METRICS = ("general_push_roofline_pct", "grid_roofline_pct",
           "general_sort_roofline_pct")
# a small deck the bricks do not tile (ny 5), whose repeat crosses the
# sort and cleaning step 20
TINY = dict(nx=30, ny=5, nz=20, nppc=2.0, num_step=22)
SEED = 2 ** 31 + 77
H100 = "NVIDIA H100 80GB HBM3"


def tiny() -> core.Spec:
    sp = core.spec(CELL)
    sp.config["params"].update(TINY)
    return sp


def test_the_cell_resolves():
    sp = core.spec(CELL)
    assert sp.cell["config"] == sp.config["name"] == "sc08"
    assert sp.cell["chips"] == 1 and sp.cell["traffic"] == "deck_run"
    assert core.reference(sp.config) is ref
    assert set(sp.limits) == set(check.NAMES)
    assert [m["name"] for m in sp.per_layer] == list(METRICS)
    assert {m["name"] for m in sp.end_to_end} == {
        "pushes_per_s", "setup_s", "peak_mem_mib"}
    for m in sp.per_layer:
        assert m["moves"] == "pushes_per_s"
        assert m["workloads"] == [CELL]
        assert callable(core.reader(m["name"]))
    cfg = sp.config
    changed = sorted(k for k, v in cfg["published"].items()
                     if cfg["params"][k] != v)
    assert changed == cfg["reduced"] == ["topology"]
    p = cfg["params"]
    assert (p["nx"], p["ny"], p["nz"], p["nppc"], p["num_step"]) == \
        (150, 25, 100, 1.0, 400)
    # the configuration holds the deck's own physics defaults
    defaults = sc08.SC08Params()
    for k in ref.KEYS:
        if k not in ("nx", "ny", "nz", "nppc"):
            assert p[k] == getattr(defaults, k), k
    g = ref.geom(p)
    assert (g.nx, g.ny, g.nz, g.clean_interval) == (150, 25, 100, 20)
    d = ref.derive(p)
    assert d["n_sheet"] + d["n_back"] == 374_999


def test_the_published_grid_takes_the_general_path():
    g = G.partition_periodic_box(-1.0, 0.0, 0.0, 1.0, 1.0, 1.0, 150, 25, 100)
    assert not FP3.supports3d(g, 750_000)
    p = dict(core.spec(CELL).config["params"], **TINY)
    sim = sc08.build(sc08.SC08Params(**p), device="cpu")
    assert sim._path()[0] == "general"


def test_the_reference_loads_nothing_of_the_program():
    probe = ("import sys; sys.path.insert(0, %r); "
             "import benchmark.reference.sc08; "
             "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))"
             % str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=str(core.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(out.stdout.split())
    assert "benchmark" in tops and "torch" in tops
    assert not tops & {"vpic_tpu_torch", "vpic_tpu", "jax", "jaxlib"}


def test_the_reference_state_is_the_decks():
    cfg = tiny().config
    p, seed = cfg["params"], cfg["load_seed"]
    sim = core.build(cfg, "cpu")
    packed = sim._pack_species()[0]
    f0 = sim._build_initial_fields()
    rf, rs = ref.load(p, seed, "cpu")
    for n in pic.FIELD_NAMES:
        assert torch.equal(getattr(f0, n), rf[n]), n
    for sp, r in zip(packed, rs):
        n = int(sp.np)
        assert n == len(r["w"])
        for k in pic.LANE_NAMES:
            assert torch.equal(getattr(sp, k)[:n], r[k]), k
    # after initialize(): the deck's fixups and the reference's
    state = sim.initialize()
    rf, rs = ref.initial_state(p, seed, "cpu")
    for n in FIELD_NAMES:
        assert torch.allclose(getattr(state.fields, n), rf[n], rtol=0,
                              atol=1e-6), n
    got = check.lane_errs(core.plain(state, sim)[1], rs, ref.geom(p),
                          ordered=True)
    assert got == {"lane_pos_err": 0.0, "lane_mom_err": 0.0,
                   "lanes_unmatched": 0.0}


def test_a_tiny_run_is_correct_and_the_control_is_not():
    sp = tiny()
    out = core.run_cell(sp, SEED, 0.2, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4 and out["failed"] == 0
    drv, _ = core.setup(sp, SEED, "cpu")
    assert drv.many.path == "general"
    start, samples = core.check_repeat(drv, sp.traffic, SEED, "sc08")
    core.free(drv)
    steps = [k for k, *_ in samples]
    assert steps[0] == 0 and 20 in steps and steps[-1] == 21
    per, ctrl, _, _ = core.compare(sp.config, SEED, start, samples, "cpu",
                                   control=True)
    nums = check.empty()
    for got in per:
        check.merge(nums, got)
    assert check.judge(nums, sp.limits)[0], nums
    assert not check.judge(ctrl, sp.limits)[0], ctrl


def _log():
    from vpic_tpu_torch.utils import profile as PF
    plain = (PF.Run("load_interpolator", "k", ()),
             PF.Run("advance_p", "sk", ((1, "fused_push3d_kernel"),)),
             PF.Run("unload_accumulator", "k", ()),
             PF.Run("field_advance", "k", ((0, "field_beb"),)))
    sort = plain[:1] + (PF.Run("sort_p", "kk", ()),) + plain[1:]
    return [sort, plain]


def _timeline():
    # a sorting replay and a plain one, each record 1 us, 1 us apart
    names = {"load_interpolator": ["interp_kernel"],
             "sort_p": ["radix_sort_kernel", "gather_kernel"],
             "advance_p": ["Memset (Device)", "void fused_push3d_kernel<1>"],
             "unload_accumulator": ["unload_kernel"],
             "field_advance": ["field_beb_grid_kernel"]}
    dev, t = [], 0.0
    for order in (("load_interpolator", "sort_p", "advance_p",
                   "unload_accumulator", "field_advance"),
                  ("load_interpolator", "advance_p", "unload_accumulator",
                   "field_advance")):
        for stage in order:
            for n in names[stage]:
                dev.append((n, t, t + 1.0))
                t += 2.0
    return trace.Timeline(device=dev, window=(0.0, t), steps=2)


def test_the_new_readers_by_hand(monkeypatch):
    from vpic_tpu_torch import step_graph
    for m in METRICS:
        assert core.reader(m)(core.Run()) is None
        assert core.reader(m)(core.Run(device_kind=H100)) is None
    log = step_graph.ReplayLog()
    for stage_map in _log():
        log.add(stage_map)
    monkeypatch.setattr(step_graph, "replay_log", log)
    run = core.Run(device_kind=H100, timeline=_timeline(), lanes=[600, 400],
                   cells=10)
    bw = 3.35e12
    # the push: push_roofline_pct's count, 61,200 bytes a step over the
    # kernel's 1 us a step
    assert core.reader("general_push_roofline_pct")(run) == \
        pytest.approx(100 * 61200 / bw / 1e-6)
    # the grid: 39 words a cell over 2 us a step (one record each stage)
    assert core.reader("grid_roofline_pct")(run) == \
        pytest.approx(100 * 10 * 39 * 4 / bw / 2e-6)
    # the sort: one firing of 2 us, 17 words a live lane
    assert core.reader("general_sort_roofline_pct")(run) == \
        pytest.approx(100 * 1000 * 17 * 4 / bw / 2e-6)
    # no traced firing: no sort share
    monkeypatch.setattr(step_graph, "replay_log", step_graph.ReplayLog())
    step_graph.replay_log.add(_log()[1])
    tl = _timeline()
    tl.device, tl.steps = tl.device[7:], 1
    plain_run = core.Run(device_kind=H100, timeline=tl, lanes=[600, 400],
                         cells=10)
    assert core.reader("general_sort_roofline_pct")(plain_run) is None
    assert core.reader("grid_roofline_pct")(plain_run) == \
        pytest.approx(100 * 10 * 39 * 4 / bw / 2e-6)


def test_the_grid_and_sort_readers_name_no_hand_kernel():
    # torch_ops_ms_per_step's hand kernels stay as they were
    for m in ("grid_roofline_pct", "general_sort_roofline_pct"):
        mod = core.metric_module(m)
        assert not hasattr(mod, "KERNELS") and not hasattr(mod, "OTHER_HAND")
    assert core.metric_module("general_push_roofline_pct").KERNELS == \
        ("fused_push3d_kernel",)
