"""The check fails what it must: the control (the reference computed in
bfloat16 in the program's place) and the program broken underneath the
timed path, each driven through the rest of a run on the CPU at a tiny
size with the cell's own limits.  The faults a one-card cell can have: a
step that returns its state unchanged, half of the lanes left out of the
push, and one lane's answer altered where the push produces it."""

import pytest

from benchmark import check, core
from benchmark.tests import bench_helpers
from vpic_tpu_torch import deck
from vpic_tpu_torch.ops import fused_push, fused_push3d

CELLS = sorted(bench_helpers.TINY)


def _run(cell):
    sp = bench_helpers.tiny(cell)
    return core.run_cell(sp, bench_helpers.SEED, 0.0, False, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    sp = bench_helpers.tiny(cell)
    drv, _ = core.setup(sp, bench_helpers.SEED, "cpu")
    start, samples = core.check_repeat(drv, sp.traffic, bench_helpers.SEED)
    core.free(drv)
    per, ctrl, _, _ = core.compare(sp.config, bench_helpers.SEED, start,
                                   samples, "cpu", control=True)
    prog = check.empty()
    for got in per:
        check.merge(prog, got)
    assert check.judge(prog, sp.limits)[0], prog
    assert not check.judge(ctrl, sp.limits)[0], ctrl


def _unchanged(monkeypatch):
    make = deck.Simulation.make_advance

    def broken(self):
        adv = make(self)

        def step(state):
            return state.replace(step=state.step + 1)

        for k in ("path", "fields", "cadence", "capture"):
            setattr(step, k, getattr(adv, k))
        return step

    monkeypatch.setattr(deck.Simulation, "make_advance", broken)


def _wrap_pushes(monkeypatch, after):
    """Each push kernel's wrapper with ``after(species_in, species_out)``
    run on its result."""
    for mod, name in ((fused_push, "fused_push_multi"),
                      (fused_push3d, "fused_push3d_multi")):
        orig = getattr(mod, name)

        def push(species, *a, _orig=orig, **kw):
            before = [{n: getattr(sp, n).clone() for n in
                       ("dx", "dy", "dz", "i", "ux", "uy", "uz")}
                      for sp in species]
            out = _orig(species, *a, **kw)
            after(before, out[0])
            return out

        monkeypatch.setattr(mod, name, push)


def _half_left_out(monkeypatch):
    def after(before, out):
        for b, sp in zip(before, out):
            half = sp.capacity // 2
            for n, v in b.items():
                getattr(sp, n)[half:] = v[half:]
    _wrap_pushes(monkeypatch, after)


def _altered(monkeypatch):
    def after(before, out):
        out[0].ux[0] += 0.1
    _wrap_pushes(monkeypatch, after)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered],
                         ids=["unchanged", "half", "altered"])
def test_a_broken_step_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1
