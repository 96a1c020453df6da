"""Restart, hydro and dumps of the port on the card.  Every test here is
marked ``gpu`` and skips without a CUDA device (decided inside the
fixture, never at import).  This file imports neither jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_io.py

Tolerances: on the card the push kernels' float atomics reorder the
accumulator's sums, so a restart is held to the ten-step tolerances of
tests/test_pallas.py:88-94 (fields 5e-7 + 1e-5 max|a|), energies to 1e-4
of the total (chip_smoke.py's RESTART_RTOL), live counts exactly; hydro on
the card to 1e-5 max|moment| of the plain (CPU) hydro of the same state."""

import numpy as np
import pytest
import torch

from vpic_tpu_torch import checkpoint as CK
from vpic_tpu_torch import dump as DU
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.models import harris
from vpic_tpu_torch.ops import fused_push as FP
from vpic_tpu_torch.ops import hydro as H

pytestmark = pytest.mark.gpu

P2D = harris.HarrisParams(nx=32, ny=32, nppc=16, Lx=8.0, Ly=8.0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _steps(sim, state, n):
    step = sim.make_step()
    for _ in range(n):
        state = step(state)
    return state


def test_harris2d_restart_on_the_card(cuda, tmp_path):
    sim = harris.build(P2D)
    state = _steps(sim, sim.initialize(), 10)
    base = CK.checkpt(state, str(tmp_path / "ck"), sim=sim)
    state = _steps(sim, state, 10)
    sim2 = harris.build(P2D)
    back = CK.restore(base, sim=sim2)
    assert back.step == 10 and back.fields.ex.device.type == "cuda"
    FP.launches = 0
    back = _steps(sim2, back, 10)
    assert FP.launches == 10
    for n in ("jfx", "ex", "ey", "cbz"):
        a = getattr(state.fields, n).cpu().numpy()
        b = getattr(back.fields, n).cpu().numpy()
        assert np.abs(a - b).max() < 5e-7 + 1e-5 * np.abs(a).max(), n
    ea = sim.energies(state).double().cpu().numpy()
    eb = sim2.energies(back).double().cpu().numpy()
    assert np.abs(ea - eb).max() <= 1e-4 * ea.sum()
    assert [int(s.np) for s in state.species] == \
        [int(s.np) for s in back.species]
    assert int(back.diag["unfinished"]) == 0


def test_hydro_on_the_card_matches_plain(cuda):
    sim = harris.build(P2D)
    state = _steps(sim, sim.initialize(), 5)
    cpu = state_from_numpy(state_to_numpy(state), device="cpu")
    for k in range(len(sim.species)):
        a = H.compute_hydro(sim, cpu, k).numpy()
        b = H.compute_hydro(sim, state, k).cpu().numpy()
        assert np.abs(a).max() > 0
        assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


def test_field_dump_of_a_card_state(cuda, tmp_path):
    """The dump of a state on the card is the dump of its CPU copy."""
    sim = harris.build(P2D)
    state = _steps(sim, sim.initialize(), 3)
    cpu = state_from_numpy(state_to_numpy(state), device="cpu")
    a = DU.dump_fields(sim, state, str(tmp_path / "a"))[0]
    b = DU.dump_fields(sim, cpu, str(tmp_path / "b"))[0]
    assert open(a, "rb").read() == open(b, "rb").read()
