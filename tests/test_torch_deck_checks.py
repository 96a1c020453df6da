"""vpic_tpu_torch/scripts/deck_checks.py, which chip_smoke.py phases 22-23
run on the card, here on the CPU at small sizes: an oracle steps only
through the caller's run() and fails naming the deck, the card-against-CPU
check with the CPU on both sides (every difference 0), and the sc08 demo
run scaled down.  The deck files (tests/test_torch_decks_*.py) run every
oracle."""

import pytest
import torch

from vpic_tpu_torch.scripts import deck_checks as DC

torch.set_num_threads(2)

SC08 = dict(nx=16, ny=8, nz=8, nppc=2)


class Counting:
    def __init__(self):
        self.steps = 0

    def __call__(self, sim, state, n):
        self.steps += n
        return DC.plain_run(sim, state, n)


@pytest.mark.parametrize("name", ["twostream", "cygnus"])
def test_oracle_runs_only_through_run(name):
    """Every step an oracle takes goes through the caller's run(), where
    chip_smoke.py counts launches and times the steps."""
    run = Counting()
    kw = dict(cygnus=dict(nx=64, nz=12)).get(name, {})
    r = DC.oracle(name, "cpu", run, **kw)
    assert run.steps == r["steps"] > 0 and r["sim"].device.type == "cpu"
    assert r["state"].step == r["steps"]


def test_oracle_failure_names_the_deck():
    """A deck that breaks its oracle raises, naming what failed."""
    with pytest.raises(AssertionError, match="sc08: total energy drift"):
        DC.oracle("sc08", "cpu", lambda sim, s, n: _heated(DC.plain_run(
            sim, s, n)), **SC08)


def _heated(state):
    for sp in state.species:
        sp.ux.mul_(1.5)
    return state


@pytest.mark.parametrize("name", ["twostream", "sc08", "cygnus"])
def test_card_vs_cpu_on_cpu(name):
    kw = dict(twostream=dict(nppc=8), sc08=SC08,
              cygnus=dict(nx=64, nz=12))[name]
    c = DC.card_vs_cpu(name, "cpu", 3, **kw)
    assert c["lane"] == c["field"] == c["energy"] == 0.0


def test_sc08_demo_scaled_down():
    r = DC.sc08_demo("cpu", n_steps=5, nx=30, ny=5, nz=20)
    g = r["sim"].grid
    assert (g.nx, g.ny, g.nz) == (30, 5, 20)
    assert r["sim"].make_step().path == "general"
    assert r["build_s"] > 0 and r["initialize_s"] > 0
