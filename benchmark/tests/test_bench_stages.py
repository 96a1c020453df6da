"""The stage readers (``benchmark/stages.py`` and its metric files) on a
synthetic timeline and a synthetic program log: the stages' device time,
the unstaged records, the idle inside and between replays, and nothing
read (no error) without a timeline or from a program that keeps no log."""

import pytest

from benchmark import core, stages, trace

STAGE_METRICS = ("load_interpolator", "sort_p", "advance_p",
                 "residency_plan", "residency_exchange",
                 "unload_accumulator", "field_advance", "clean_div", "carry")
H100 = "NVIDIA H100 80GB HBM3"


def _program_log():
    from vpic_tpu_torch.utils import profile as PF
    return (PF.Run("load_interpolator", "k", ()),
            PF.Run("advance_p", "kk", ((1, "fused_push3d_kernel"),)),
            PF.Run("residency_exchange", "k", ((0, "set_condition_kernel"),)),
            PF.If("residency_exchange", "merge", (
                PF.Run("residency_exchange", "k", ((0, "merge_kernel"),)),)),
            PF.Run("field_advance", "k", ((0, "field_beb"),)),
            PF.Run("carry", "c", ()))


def _replay(t):
    # 7 records of 1 us, 1 us apart
    names = ["elementwise_kernel", "fill_kernel", "fused_push3d_kernel",
             "set_condition_kernel", "merge_kernel(MergeArgs)",
             "field_beb_grid_kernel", "Memcpy DtoD (Device -> Device)"]
    return [(n, t + 2.0 * j, t + 2.0 * j + 1.0) for j, n in enumerate(names)]


def _run(monkeypatch, stray=()):
    from vpic_tpu_torch import step_graph
    log = step_graph.ReplayLog()
    for _ in range(2):
        log.add(_program_log())
    monkeypatch.setattr(step_graph, "replay_log", log)
    # two replays 10 us apart, then the energies between repeats
    dev = _replay(0.0) + _replay(23.0) + list(stray) + \
        [("energy_kernel", 40.0, 42.0)]
    tl = trace.Timeline(device=dev, window=(0.0, 50.0), steps=2,
                        labels=[("bench.energies", 40.0, 42.0)])
    return core.Run(device_kind=H100, timeline=tl)


def test_stage_times_and_gaps(monkeypatch):
    run = _run(monkeypatch)
    read = {m: core.reader(m)(run) for m in
            [f"{s}_ms_per_step" for s in STAGE_METRICS + ("unstaged",)]
            + ["graph_gap_us_per_step", "launch_gap_us_per_step"]}
    # per step: 2 us of advance_p, 2 of residency_exchange, 1 each of the
    # interpolator, the field advance and the carry; none unstaged
    assert read["advance_p_ms_per_step"] == pytest.approx(2e-3)
    assert read["residency_exchange_ms_per_step"] == pytest.approx(2e-3)
    for s in ("load_interpolator", "field_advance", "carry"):
        assert read[f"{s}_ms_per_step"] == pytest.approx(1e-3)
    for s in ("sort_p", "residency_plan", "unload_accumulator", "clean_div",
              "unstaged"):
        assert read[f"{s}_ms_per_step"] == 0.0
    # 6 us idle inside each replay; 10 us between the two, over 2 steps
    assert read["graph_gap_us_per_step"] == pytest.approx(6.0)
    assert read["launch_gap_us_per_step"] == pytest.approx(5.0)
    # the stages and the unstaged records are the step's device time
    total = sum(e - s for _, s, e in run.timeline.step_device())
    assert sum(v for k, v in read.items() if k.endswith("ms_per_step")) == \
        pytest.approx(total / 1e3 / 2)


def test_a_stray_record_is_unstaged(monkeypatch):
    run = _run(monkeypatch, stray=[("stray_kernel", 37.0, 38.0)])
    assert core.reader("unstaged_ms_per_step")(run) == pytest.approx(0.5e-3)
    assert core.reader("advance_p_ms_per_step")(run) == pytest.approx(2e-3)


def test_nothing_to_read(monkeypatch):
    assert stages.attribution(core.Run()) is None
    for m in STAGE_METRICS + ("unstaged",):
        assert core.reader(f"{m}_ms_per_step")(core.Run()) is None
    # a program that keeps no replay log, as before the stage maps
    run = _run(monkeypatch)
    from vpic_tpu_torch import step_graph
    monkeypatch.delattr(step_graph, "replay_log")
    for m in ("advance_p_ms_per_step", "unstaged_ms_per_step",
              "graph_gap_us_per_step", "launch_gap_us_per_step"):
        assert core.reader(m)(run) is None


def test_stage_files_name_no_hand_kernel():
    # the stage readers leave torch_ops_ms_per_step's hand kernels as
    # they were
    for s in STAGE_METRICS + ("unstaged",):
        mod = core.metric_module(f"{s}_ms_per_step")
        assert not hasattr(mod, "KERNELS") and not hasattr(mod, "OTHER_HAND")
