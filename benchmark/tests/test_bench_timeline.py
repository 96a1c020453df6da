"""The trace arithmetic and the roofline byte counts against hand-reckoned
values, on a synthetic timeline and at a small size."""

import pytest
import torch

from benchmark import core, trace
from benchmark.reference import pic

H100 = "NVIDIA H100 80GB HBM3"


def _timeline(steps=2):
    # two kernels that overlap by 5 us, a copy, a third kernel; a window of
    # 50 us: busy 15 + 5 + 10 = 30 us
    return trace.Timeline(
        device=[("k1", 0.0, 10.0), ("k2", 5.0, 15.0),
                ("Memcpy DtoD (Device -> Device)", 20.0, 25.0),
                ("k3", 30.0, 40.0)],
        host=[("bench.steps", 0.0, 18.0), ("cudaGraphLaunch", 14.0, 16.0),
              ("bench.restore", 18.0, 50.0)],
        window=(0.0, 50.0), steps=steps)


def _run(tl, **kw):
    run = core.Run(device_kind=H100, timeline=tl)
    for k, v in kw.items():
        setattr(run, k, v)
    return run


def test_union_not_sum():
    tl = _timeline()
    assert tl.busy_us() == pytest.approx(30.0)
    assert core.reader("device_idle_pct")(_run(tl)) == pytest.approx(40.0)
    assert tl.gaps() == [(15.0, 20.0), (25.0, 30.0), (40.0, 50.0)]
    assert trace.merged([("a", -5.0, 3.0), ("b", 2.0, 4.0),
                         ("c", 49.0, 60.0)], (0.0, 50.0)) == \
        [(0.0, 4.0), (49.0, 50.0)]


def test_kernel_counts_and_times():
    tl = _timeline(steps=2)
    run = _run(tl)
    assert core.reader("kernels_per_step")(run) == pytest.approx(1.5)
    assert tl.time_us(["k1", "k3"]) == pytest.approx(20.0)
    # every activity but the port's hand kernels: all 35 us here
    assert core.reader("torch_ops_ms_per_step")(run) == \
        pytest.approx(35.0 / 1e3 / 2)


def test_work_between_repeats_is_no_step_work():
    # the restore's device span holds the copy and a kernel; the energies'
    # span holds nothing
    tl = _timeline(steps=2)
    tl.device.append(("restore_kernel", 26.0, 28.0))
    tl.labels = [("bench.restore", 20.0, 28.0), ("bench.energies", 17.0, 19.0),
                 ("bench.steps", 0.0, 15.0)]
    run = _run(tl)
    assert [s[0] for s in tl.step_device()] == ["k1", "k2", "k3"]
    assert core.reader("kernels_per_step")(run) == pytest.approx(1.5)
    assert core.reader("torch_ops_ms_per_step")(run) == \
        pytest.approx(30.0 / 1e3 / 2)
    # the idle share is the whole window's, restores included
    assert core.reader("device_idle_pct")(run) == pytest.approx(36.0)


def test_hand_kernels_come_from_the_metric_files():
    hand = core.hand_kernels()
    for path in sorted((core.HERE / "metrics").glob("*.py")):
        for k in getattr(core.metric_module(path.stem), "KERNELS", ()):
            assert k in hand
    assert "set_condition_kernel" in hand
    tl = trace.Timeline(device=[("void fused_push3d_kernel<false>", 0, 1.0),
                                ("merge_kernel(MergeArgs)", 1.0, 2.0),
                                ("set_condition_kernel(handle)", 2.0, 3.0),
                                ("elementwise_kernel", 3.0, 7.0)],
                        window=(0.0, 7.0), steps=1)
    assert core.reader("torch_ops_ms_per_step")(_run(tl)) == \
        pytest.approx(4.0 / 1e3)


def test_breakdown_names_gaps_by_host_range():
    b = _timeline().breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(10e-6)]
    gaps = b["idle_gaps"]
    assert gaps[0] == ["bench.restore | after k3", pytest.approx(10e-6)]
    assert gaps[1] == ["cudaGraphLaunch | after k2", pytest.approx(5e-6)]
    assert gaps[2][0] == "bench.restore | after Memcpy DtoD (Device -> Device)"
    assert len(gaps) == 3


def test_push_roofline_by_hand():
    from benchmark.metrics import push_roofline_pct as m
    # 1,000 lanes: 15 words each (8 read, 7 written); 10 cells: 30 words
    assert m.bytes_per_step(1000, 10) == 1000 * 60 + 10 * 120
    tl = trace.Timeline(device=[("void fused_push3d_kernel<false>", 0, 1.0),
                                ("other", 1.0, 5.0)],
                        window=(0.0, 5.0), steps=1)
    run = _run(tl, lanes=[600, 400], cells=10)
    # 61,200 bytes / 3.35e12 B/s over 1 us
    assert core.reader("push_roofline_pct")(run) == \
        pytest.approx(100 * 61200 / 3.35e12 / 1e-6)


def test_field_roofline_by_hand():
    from benchmark.metrics import field_roofline_pct as m
    assert m.bytes_per_step(1000) == 84000
    tl = trace.Timeline(device=[("field_beb_grid_kernel", 0.0, 2.0)],
                        window=(0.0, 2.0), steps=2)
    run = _run(tl, cells=1000)
    assert core.reader("field_roofline_pct")(run) == \
        pytest.approx(100 * 84000 / 3.35e12 / 1e-6)


def test_merge_roofline_counts_leavers():
    from benchmark.metrics import merge_roofline_pct as m
    g = pic.Geom(nx=16, ny=16, nz=16, dx=1, dy=1, dz=1, dt=0.1, cvac=1,
                 eps0=1, field_bc=(0,) * 6, particle_bc=(0,) * 6, damp=0,
                 clean_interval=0)

    def vox(x, y, z):
        return x + g.NX * (y + g.NY * z)

    pre = torch.tensor([vox(1, 1, 1), vox(8, 1, 1), vox(9, 9, 9)])
    post = torch.tensor([vox(2, 1, 1), vox(9, 1, 1), vox(9, 9, 8)])
    tl = trace.Timeline(device=[("merge_kernel(MergeArgs)", 0.0, 1.0)],
                        window=(0.0, 1.0), steps=1)
    run = _run(tl, geom=g, moves=[([pre], [post])])
    # two of the three lanes left their 8^3 brick: 65 bytes each
    assert m.leavers([pre], [post], g) == 2
    assert m.bytes_per_step(2) == 130
    assert core.reader("merge_roofline_pct")(run) == \
        pytest.approx(100 * 130 / 3.35e12 / 1e-6)
    # before the check, or with no merge kernel in the trace: no reading
    assert core.reader("merge_roofline_pct")(_run(tl)) is None
    no_merge = trace.Timeline(device=[("k", 0.0, 1.0)], window=(0.0, 1.0),
                              steps=1)
    assert core.reader("merge_roofline_pct")(
        _run(no_merge, geom=g, moves=[([pre], [post])])) is None


def test_unknown_card_reads_no_share():
    tl = trace.Timeline(device=[("field_beb", 0.0, 1.0)], window=(0, 1),
                        steps=1)
    run = _run(tl, cells=10)
    run.device_kind = "a card with no published peak here"
    assert core.reader("field_roofline_pct")(run) is None
