"""The window's repeat-and-restore loop and a whole run, on the CPU at a
tiny size through the harness's own functions (the measured command
itself needs a card)."""

import subprocess
import sys

import pytest
import torch

from benchmark import check, core
from benchmark.tests import bench_helpers
from vpic_tpu_torch.state import FIELD_NAMES, SPECIES_NAMES


def _same(a, b):
    for n in FIELD_NAMES:
        assert torch.equal(getattr(a.fields, n), getattr(b.fields, n)), n
    for x, y in zip(a.species, b.species):
        for n in SPECIES_NAMES:
            assert torch.equal(getattr(x, n), getattr(y, n)), n
    assert a.step == b.step


@pytest.mark.parametrize("cell", sorted(bench_helpers.TINY))
def test_repeat_restores_the_initial_state_in_place(cell):
    sp = bench_helpers.tiny(cell)
    sp.config["params"]["taui"] = 4.0
    drv, _ = core.setup(sp, bench_helpers.SEED, "cpu")
    ptrs = [getattr(drv.state.fields, n).data_ptr() for n in FIELD_NAMES]
    drv.repeat()
    drv.repeat()
    assert drv.repeats == 2 and len(drv.energies) == 2
    # the same storage, holding the initial state again
    assert ptrs == [getattr(drv.state.fields, n).data_ptr()
                    for n in FIELD_NAMES]
    _same(drv.state, drv.snap)
    # each repeat is the deck's own run: same length, same energies
    assert drv.repeat_len == drv.sim.num_step
    e = [float(x.double().sum()) for x in drv.energies]
    assert e[0] == pytest.approx(e[1], rel=1e-6)
    assert max(drv.drifts()) < 1e-2


def test_seeds_order_one_load():
    sp = bench_helpers.tiny("harris2d.64sq.64ppc")
    a, _ = core.setup(sp, 1, "cpu")
    b, _ = core.setup(sp, 2, "cpu")
    for x, y in zip(a.snap.species, b.snap.species):
        # the same lanes, in another order
        assert not torch.equal(x.ux, y.ux)
        assert torch.equal(torch.sort(x.ux).values, torch.sort(y.ux).values)
    # each species' pairs stay pairs
    ion, ele = a.snap.species
    assert torch.equal(ion.i, ele.i) and torch.equal(ion.dx, ele.dx)
    assert core.orders(7, [5, 5, 3])[0].tolist() == \
        core.orders(7, [5, 5, 3])[1].tolist()


@pytest.mark.parametrize("cell", sorted(bench_helpers.TINY))
def test_a_tiny_run_is_correct(cell):
    sp = bench_helpers.tiny(cell)
    out = core.run_cell(sp, bench_helpers.SEED, 0.5, False, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 4 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"pushes_per_s", "setup_s",
                                   "peak_mem_mib"}
    assert out["metrics"]["pushes_per_s"]["value"] > 0


def test_the_check_samples_every_cadence():
    sp = bench_helpers.tiny("harris2d.64sq.64ppc")
    drv, _ = core.setup(sp, bench_helpers.SEED, "cpu")
    start, samples = core.check_repeat(drv, sp.traffic, bench_helpers.SEED)
    steps = [k for k, *_ in samples]
    n = drv.repeat_len
    assert steps[0] == 0 and steps[-1] == n - 1
    cads = {drv.cadence(k, drv.state.diag) for k in steps[1:-1]}
    assert len(cads) == len({drv.cadence(k, drv.state.diag)
                             for k in range(1, n - 1)})
    # the check repeat leaves the initial state in place
    _same(drv.state, drv.snap)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run(
        [sys.executable, str(core.HERE / "run.py"), "--workload",
         "harris2d.64sq.64ppc", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(core.ROOT))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_judge_takes_every_number():
    ok, rows = check.judge(check.empty(), dict.fromkeys(check.NAMES, 0.0))
    assert ok and [r[0] for r in rows] == list(check.NAMES)
    bad = dict(check.empty(), e_err=float("nan"))
    merged = check.empty()
    check.merge(merged, bad)
    assert not check.judge(merged, dict.fromkeys(check.NAMES, 1.0))[0]
