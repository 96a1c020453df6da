"""The port's 2-D harris main path against vpic_tpu's general path
(use_pallas=False, the oracle tests/test_pallas.py holds the fused kernel
to): 10 steps of the 16^2 x 4 ppc deck at bucket-sort intervals 1 and 8,
fields to 5e-7 + 1e-5 max|a| and energies to 1e-6 sum
(test_pallas.py:88-94)."""

import jax
import numpy as np
import pytest
import torch

import vpic_tpu_torch.ops.fused_push as FP

from torch_parity import assert_close_rel, build_pair, np_

torch.set_num_threads(2)

N_STEPS = 10


def _energies(sim, state):
    """vpic_tpu's energies, run op by op: the jitted Simulation.energies
    fuses its float32 sums into a less accurate order (its bz energy is
    1.1e-6 of the total off the float64 sum at step 0 of this deck), which
    would spend the whole 1e-6 budget on the reference's own rounding."""
    return np.asarray(sim._energies_local(state.fields, state.species),
                      np.float64)


@pytest.fixture(scope="module")
def reference():
    """vpic_tpu's general path: initial and 10-step energies and state."""
    sj, _ = build_pair()
    sj.use_pallas = False
    s = sj.initialize()
    e0 = _energies(sj, s)
    adv = jax.jit(sj.make_advance())
    for _ in range(N_STEPS):
        s = adv(s)
    return sj, s, e0, _energies(sj, s)


def _run_port(sort_interval, n_steps=N_STEPS):
    _, st = build_pair()
    st.pallas_sort_interval = sort_interval
    s = st.initialize()
    e0 = st.energies(s).double().numpy()
    step = st.make_step()
    for _ in range(n_steps):
        s = step(s)
    return st, s, e0


def test_step0_energies_match(reference):
    _, _, e0_ref, _ = reference
    _, _, e0 = _run_port(8, n_steps=0)
    assert np.abs(e0_ref - e0).max() / e0_ref.sum() < 1e-6


@pytest.mark.parametrize("K", [1, 8])
def test_ten_steps_match_jax(reference, K):
    _, s_ref, _, e_ref = reference
    st, s, _ = _run_port(K)
    assert s.step == N_STEPS
    for n in ("jfx", "ex", "ey", "cbz"):
        assert_close_rel(getattr(s_ref.fields, n), getattr(s.fields, n),
                         1e-5, 5e-7, n)
    e = st.energies(s).double().numpy()
    assert np.abs(e_ref - e).max() / e_ref.sum() < 1e-6
    assert int(s.diag["unfinished"]) == 0
    for sp_ref, sp in zip(s_ref.species, s.species):
        assert int(sp.np) == int(sp_ref.np)
        assert int(sp.live.sum()) == int(sp_ref.np)


def test_run_matches_stepping(capsys):
    """Simulation.run drives the same step: identical to stepping by hand,
    with status lines on the status interval."""
    st, s_hand, _ = _run_port(8, n_steps=4)
    _, st2 = build_pair()
    st2.status_interval = 2
    s_run = st2.run(num_step=4)
    assert s_run.step == 4
    for n in ("ex", "cbz", "jfy"):
        assert torch.equal(getattr(s_hand.fields, n),
                           getattr(s_run.fields, n)), n
    assert "Completed step 4 of 4" in capsys.readouterr().out


def test_step_goes_through_fused_push(monkeypatch):
    """Every step pushes all species through fused_push_multi once."""
    calls = []
    real = FP.fused_push_multi

    def spy(species, *a, **kw):
        calls.append(len(species))
        return real(species, *a, **kw)

    monkeypatch.setattr(FP, "fused_push_multi", spy)
    _run_port(8, n_steps=3)
    assert calls == [2, 2, 2]


def test_step_does_not_read_the_device(monkeypatch):
    """No host sync on the step path: Tensor.item / nonzero / numpy /
    tolist are never called while stepping."""
    st, s, _ = _run_port(8, n_steps=0)
    step = st.make_step()

    def forbid(name):
        def f(*a, **kw):
            raise AssertionError(f"step called Tensor.{name}")
        return f

    for name in ("item", "nonzero", "numpy", "tolist", "__bool__",
                 "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, forbid(name))
    for _ in range(9):
        s = step(s)
    monkeypatch.undo()
    assert s.step == 9


def test_energies_are_float32_device_tensor():
    st, s, e0 = _run_port(8, n_steps=0)
    e = st.energies(s)
    assert e.dtype == torch.float32 and e.shape == (8,)
    assert np.isfinite(np_(e)).all()
