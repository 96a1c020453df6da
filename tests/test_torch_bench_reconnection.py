"""The benchmark's collisional reconnection cell
(``reconnection3d.32cube.128ppc.tau5``) on the CPU:

* the cell resolves: its configuration, traffic, limits, per-layer
  metrics and plain reference (``benchmark/reference/
  collisional_reconnection.py``), which is the composition of the
  reference's parts that ``benchmark/tests/collisional_reference.py``
  makes, function for function, and which loads nothing of the program;
* the port's reconnection deck at 8^3 cells, 8 particles a cell, the
  three Takizuka-Abe ops every 2 steps, through the harness's own
  ``core.setup`` / ``check_repeat`` / ``compare``, is correct within the
  cell's limits, and the bfloat16 control is not;
* the byte count of ``collision_roofline_pct`` and the reader of
  ``overflow_rebuckets_per_step``."""

import subprocess
import sys

import pytest
import torch

from benchmark import check, core, trace
from benchmark.reference import collisional_reconnection as ref
from benchmark.tests import bench_helpers
from benchmark.tests import collisional_reference as composed
from vpic_tpu_torch import step_graph as SG
from vpic_tpu_torch.ops import residency as RES

import plan_cases as PC

torch.set_num_threads(2)

CELL = "reconnection3d.32cube.128ppc.tau5"
TINY = dict(bench_helpers.TINY["harris3d.32cube.128ppc"], tau_coll_interval=2)


def test_the_cell_resolves():
    sp = core.spec(CELL)
    assert sp.cell["config"] == sp.config["name"] == "reconnection3d"
    assert sp.config["reference"] == "collisional_reconnection"
    assert core.reference(sp.config) is ref
    assert sp.traffic == core.spec("harris3d.32cube.128ppc").traffic
    assert sp.limits == core.spec("harris3d.32cube.128ppc").limits
    assert [m["name"] for m in sp.per_layer] == [
        "collision_ms_per_step", "collision_roofline_pct",
        "overflow_rebuckets_per_step"]
    assert {m["name"] for m in sp.end_to_end} == {
        "pushes_per_s", "setup_s", "peak_mem_mib"}
    for m in sp.per_layer:
        assert callable(core.reader(m["name"]))
    p = sp.config["params"]
    assert (p["nx"], p["ny"], p["nz"], p["nppc"]) == (32, 32, 32, 128.0)
    assert (p["tau_coll_interval"], p["log_lambda"], p["coll_n0"]) == \
        (5, 10.0, 1.0)
    g = ref.geom(p)
    assert (g.nz, g.log_lambda, g.n0) == (32, 10.0, 1.0)


def test_the_reference_is_the_tests_composition():
    p = dict(core.spec(CELL).config["params"], **TINY)
    assert ref.geom(p) == composed.geom(p)
    assert ref.field_scales is composed.field_scales
    assert ref.initial_state is composed.initial_state
    assert ref.step.__code__.co_code == composed.step.__code__.co_code


def test_the_reference_loads_nothing_of_the_program():
    probe = ("import sys; sys.path.insert(0, %r); "
             "import benchmark.reference.collisional_reconnection; "
             "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))"
             % str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, cwd=str(core.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(out.stdout.split())
    assert "benchmark" in tops and "torch" in tops
    assert not tops & {"vpic_tpu_torch", "vpic_tpu", "jax", "jaxlib"}


@pytest.fixture(scope="module")
def checked():
    """(spec, start, samples) of one check repeat of the tiny deck."""
    sp = core.spec(CELL)
    sp.config["params"].update(TINY)
    drv, _ = core.setup(sp, bench_helpers.SEED, "cpu")
    start, samples = core.check_repeat(drv, sp.traffic, bench_helpers.SEED,
                                       sp.config["name"])
    core.free(drv)
    return sp, start, samples


def test_the_tiny_deck_is_correct_and_the_control_is_not(checked):
    sp, start, samples = checked
    fired = [k for k, *_, draws in samples if draws is not None]
    assert 0 in fired and len(fired) >= 2
    per, ctrl, _, _ = core.compare(sp.config, bench_helpers.SEED, start,
                                   samples, "cpu", control=True)
    nums = check.empty()
    for got in per:
        check.merge(nums, got)
        assert got["lanes_unmatched"] == 0
    assert check.judge(nums, sp.limits)[0], nums
    assert not check.judge(ctrl, sp.limits)[0], ctrl


def test_the_collision_bytes_a_firing():
    roof = core.metric_module("collision_roofline_pct")
    n = 2_097_152
    # lanes: ion-ion n, electron-electron n, electron-ion 2n, 9 words each;
    # pairs: n / 2, n / 2 and n, 4 words each
    assert roof.bytes_per_firing([n, n]) == 4 * (4 * n * 9 + 2 * n * 4)
    assert roof.read(core.Run()) is None


def test_overflow_rebuckets_read_the_programs_log():
    """The reader takes the rebuckets whose plan overflowed an outbox or the
    exchange over the window's steps, from the log of the stretch of
    profiled replays (here its ends are marked by hand around three plans
    on CPU tensors, one of each cause)."""
    read = core.reader("overflow_rebuckets_per_step")
    run = core.Run(timeline=trace.Timeline(steps=4))
    SG.replay_log.clear()
    assert read(run) is None
    SG.rebucket_log.begin()
    for case in ("outbox_cap", "over_maxin", "roomy_stray"):
        args, kw = PC.plan_inputs(case)
        RES.plan(*args, **kw)
    SG.rebucket_log.end()
    args, kw = PC.plan_inputs("outbox_cap")
    RES.plan(*args, **kw)
    assert SG.rebucket_log.counts() == {"outbox": 1, "exchange": 1,
                                        "misplaced": 1}
    assert read(run) == 2 / 4
    SG.replay_log.clear()
    assert read(run) is None
