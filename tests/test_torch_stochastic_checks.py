"""The card-against-CPU checks of vpic_tpu_torch/scripts/stochastic_checks.py
(chip_smoke.py phases 18, 20 and 21), run here with the CPU on both sides:
every op passes against itself, and a check fails on a changed lane, a
changed momentum or another permutation."""

import pytest
import torch

import vpic_tpu_torch as vt
from vpic_tpu_torch.models import emission
from vpic_tpu_torch.scripts import stochastic_checks as SC

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def box():
    g = SC.collision_grid(8)
    n = 1 << 12
    return g, n, [SC.collision_species(n, g, seed=0),
                  SC.collision_species(n, g, seed=1)]


@pytest.mark.parametrize("name", ["hard_sphere", "takizuka_abe",
                                  "takizuka_abe_inter",
                                  "large_angle_coulomb", "langevin"])
def test_collision_checks_pass_on_the_cpu(box, name):
    g, n, host = box
    assert SC.compare_collision_op(SC.collision_ops(g, n)[name], host, g,
                                   "cpu") == 0.0


def test_collision_check_sees_a_difference(box, monkeypatch):
    g, n, host = box
    op = SC.collision_ops(g, n)["takizuka_abe_inter"]
    real = SC.to

    def nudge(tree, device):
        out = real(tree, device)
        if isinstance(tree, list) and isinstance(tree[0], dict):
            out[0]["theta"] = out[0]["theta"] * 1.5
        return out

    monkeypatch.setattr(SC, "to", nudge)
    with pytest.raises(AssertionError, match="max abs err"):
        SC.compare_collision_op(op, host, g, "cpu")


def test_lane_check_sees_a_difference(box):
    _, _, host = box
    a = host[0]
    b = SC.to(a, "cpu")
    b.i[7] += 1
    with pytest.raises(AssertionError, match="i differs"):
        SC.compare_lanes(a, b, 3e-5, "x")
    b = SC.to(a, "cpu")
    b.uy[3] += 1e-4
    with pytest.raises(AssertionError, match="uy"):
        SC.compare_lanes(a, b, 3e-5, "x")


def test_emitter_and_aged_checks_on_the_cpu():
    sim = emission.build(emission.EmissionParams(nx=16, ny=4, Lx=0.5,
                                                 Ly=0.125), device="cpu")
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(3):
        state = step(state)
    err, new = SC.compare_child_langmuir(sim, state, "cpu")
    assert err == 0.0 and new > 0
    err, killed = SC.compare_aged_initialize(vt, "cpu", 600)
    assert err == 0.0 and killed > 0
