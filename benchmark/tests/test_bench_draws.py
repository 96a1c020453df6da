"""The check of a step that draws random numbers: the collisional
reconnection deck at a tiny size (8^3 cells, 8 particles a cell, the
three Takizuka-Abe ops every 2 steps), through the harness's own
functions, with ``collisional_reference`` as its configuration's
reference and the 3-D cell's limits; and the harris cells, which draw
nothing, checked exactly as by ``pic.step``."""

import dataclasses

import pytest
import torch

from benchmark import check, core
from benchmark.reference import collision, pic
from benchmark.tests import bench_helpers
from benchmark.tests import collisional_reference as recon
from vpic_tpu_torch import collision as program_collision

CELL = "harris3d.32cube.128ppc"
INTERVAL = 2


def _spec() -> core.Spec:
    sp = bench_helpers.tiny(CELL)
    return dataclasses.replace(sp, name="reconnection.tiny",
                               config=recon.config(sp.config, INTERVAL))


@pytest.fixture(scope="module")
def checked():
    """(spec, start, samples) of one check repeat of the tiny deck."""
    recon.register()
    sp = _spec()
    drv, _ = core.setup(sp, bench_helpers.SEED, "cpu")
    lanes = [int(s.np) for s in drv.state.species]
    start, samples = core.check_repeat(drv, sp.traffic, bench_helpers.SEED,
                                       "reconnection")
    core.free(drv)
    return sp, start, samples, lanes


def _numbers(per):
    nums = check.empty()
    for got in per:
        check.merge(nums, got)
    return nums


def test_firing_steps_carry_the_programs_draws(checked):
    sp, _, samples, lanes = checked
    fired = [k for k, *_ in samples if k % INTERVAL == 0]
    assert 0 in fired and len(fired) >= 2
    for k, pre, _, draws in samples:
        if k % INTERVAL:
            assert draws is None, k
            continue
        assert [op["pair"] for op in draws] == [(0, 0), (1, 1), (1, 0)]
        for op in draws:
            i, j = op["pair"]
            assert op["interval"] == INTERVAL
            (r,) = op["rounds"]
            # one key a live lane, one variate a pair of the live prefix
            assert r["shuf_i"].numel() == pre[1][i]["w"].numel() == lanes[i]
            n = lanes[i] // 2 if i == j else lanes[i]
            assert {v.numel() for key, v in r.items()
                    if not key.startswith("shuf")} == {n}
            if i != j:
                assert r["shuf_j"].numel() == lanes[j]


def test_the_collision_steps_agree_with_the_reference(checked):
    sp, start, samples, _ = checked
    per, _, moves, _ = core.compare(sp.config, bench_helpers.SEED, start,
                                    samples, "cpu")
    for got in per:
        assert check.judge(dict(check.empty(), **got), sp.limits)[0], got
        assert got["lanes_unmatched"] == 0
    # the reference keeps the lanes' order through the ops
    for (k, pre, *_), (before, _) in zip(samples, moves):
        for b, sp_pre in zip(before, pre[1]):
            assert torch.equal(b, sp_pre["i"])


def test_the_control_is_not_correct(checked):
    sp, start, samples, _ = checked
    per, ctrl, _, _ = core.compare(sp.config, bench_helpers.SEED, start,
                                   samples, "cpu", control=True)
    assert check.judge(_numbers(per), sp.limits)[0]
    assert not check.judge(ctrl, sp.limits)[0], ctrl


def test_fresh_draws_are_not_correct(checked):
    sp, start, samples, _ = checked
    gen = torch.Generator().manual_seed(5)

    def fresh(v, key):
        if key.startswith("shuf"):
            return torch.randint(0, 2 ** 31, v.shape, generator=gen,
                                 dtype=v.dtype)
        if key == "theta":
            return torch.randn(v.shape, generator=gen)
        return torch.rand(v.shape, generator=gen)

    swapped = []
    for k, pre, post, draws in samples:
        if draws is not None:
            draws = [dict(op, rounds=[{key: fresh(v, key)
                                       for key, v in r.items()}
                                      for r in op["rounds"]])
                     for op in draws]
        swapped.append((k, pre, post, draws))
    per, _, _, _ = core.compare(sp.config, bench_helpers.SEED, start,
                                swapped, "cpu")
    assert not check.judge(_numbers(per), sp.limits)[0]


def _numbers_of_a_run(sp):
    drv, _ = core.setup(sp, bench_helpers.SEED, "cpu")
    start, samples = core.check_repeat(drv, sp.traffic, bench_helpers.SEED,
                                       "reconnection")
    core.free(drv)
    return _numbers(core.compare(sp.config, bench_helpers.SEED, start,
                                 samples, "cpu")[0])


def _other_branch(monkeypatch, near: float):
    """The program's T1 built on the other branch (the second smallest
    component of u_r zeroed) for pairs whose two smallest components lie
    within ``near`` of their sum; returns the list its flips count into."""
    flips = []

    def perp(urx, ury, urz):
        mag = torch.stack([urx.abs(), ury.abs(), urz.abs()])
        srt, axes = torch.sort(mag, dim=0, stable=True)
        other = srt[1] - srt[0] <= near * mag.sum(0)
        flips.append(int(other.sum()))
        axis = torch.where(other, axes[1], axes[0])
        zero = torch.zeros_like(urx)
        t = (torch.where(axis == 0, zero, torch.where(axis == 1, -urz, -ury)),
             torch.where(axis == 1, zero, torch.where(axis == 0, -urz, urx)),
             torch.where(axis == 2, zero, torch.where(axis == 0, ury, urx)))
        tn = torch.rsqrt(torch.clamp(t[0] * t[0] + t[1] * t[1]
                                     + t[2] * t[2], min=1e-30))
        return tuple(c * tn for c in t)

    monkeypatch.setattr(program_collision, "_perp_vector", perp)
    return flips


def test_two_valued_pairs_take_the_programs_branch(monkeypatch):
    """A program whose rounding takes T1's other branch at near-equal
    components (here made to, over a wider band than rounding reaches)
    is correct; without settling the branches it would not read so."""
    recon.register()
    monkeypatch.setattr(collision, "TWO_VALUED", 5e-4)
    flips = _other_branch(monkeypatch, 2.5e-4)
    sp = _spec()
    assert check.judge(_numbers_of_a_run(sp), sp.limits)[0]
    assert sum(flips) > 0
    monkeypatch.setattr(core, "settle",
                        lambda ref_step, pre, post, k, draws, got, g:
                        (draws,) + tuple(got))
    assert not check.judge(_numbers_of_a_run(sp), sp.limits)[0]


def test_a_program_on_the_other_branch_everywhere_is_not_correct(
        monkeypatch):
    recon.register()
    _other_branch(monkeypatch, float("inf"))
    sp = _spec()
    assert not check.judge(_numbers_of_a_run(sp), sp.limits)[0]


def test_an_undeclared_draw_stops_the_run(monkeypatch):
    recon.register()
    build = core.build

    def one_more(config, device):
        sim = build(config, device)
        op = sim.collision_ops[0]

        def patched(species, f, g, step, generator, diag=None):
            if step % op.interval == 0:
                torch.rand(1, generator=generator)
            return op(species, f, g, step, generator, diag)

        patched.__dict__.update(op.__dict__)
        sim.collision_ops[0] = patched
        return sim

    monkeypatch.setattr(core, "build", one_more)
    sp = _spec()
    sp.config["params"]["taui"] = 4.0
    drv, _ = core.setup(sp, bench_helpers.SEED, "cpu")
    with pytest.raises(RuntimeError, match=r"reconnection, step 0:"):
        core.check_repeat(drv, sp.traffic, bench_helpers.SEED,
                          "reconnection")


@pytest.mark.parametrize("cell", sorted(bench_helpers.TINY))
def test_a_deck_that_draws_nothing_steps_as_pic_step(cell):
    sp = bench_helpers.tiny(cell)
    drv, _ = core.setup(sp, bench_helpers.SEED, "cpu")
    start, samples = core.check_repeat(drv, sp.traffic, bench_helpers.SEED)
    core.free(drv)
    assert all(draws is None for *_, draws in samples)
    per, _, _, _ = core.compare(sp.config, bench_helpers.SEED, start,
                                samples, "cpu")
    ref = core.reference(sp.config)
    g = ref.geom(sp.config["params"])
    floors = ref.field_scales(sp.config["params"])
    for (k, pre, post, _), got in zip(samples, per[1:]):
        rf, rs = pic.step(pre[0], pre[1], g, k)
        groups = ("e_err", "b_err", "jf_err")
        if k % g.clean_interval == 0:
            groups += ("rho_err",)
        want = check.lane_errs(post[1], rs, g)
        want.update(check.field_errs(post[0], rf, groups, floors))
        assert got == want, k
