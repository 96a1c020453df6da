"""The port's weibel deck (vpic_tpu_torch/models/weibel.py) on the CPU, where
its 2-D kernel path runs the plain versions: the 100-step energy history
against tests/data/weibel_energies_gold.txt at test_energy_gold.py's
per-column RTOL, and a small run against vpic_tpu's general path
(use_pallas=False) to the ten-step tolerances of tests/test_pallas.py:88-94
(fields 5e-7 + 1e-5 max|a|, energies 1e-6 of their sum)."""

import jax
import numpy as np
import torch

import vpic_tpu.models.weibel as weibel_jax
import vpic_tpu_torch.models.weibel as weibel_torch
from test_energy_gold import COLS, GOLD, RTOL

from torch_parity import np_

torch.set_num_threads(2)


def test_weibel_energies_match_gold():
    gold = np.loadtxt(GOLD)
    p = weibel_torch.WeibelParams(nx=16, ny=16, nppc=16, Lx=8.0, Ly=8.0,
                                  uth_perp=0.4, uth_par=0.1, seed=7)
    sim = weibel_torch.build(p, device="cpu")
    state = sim.initialize()
    step = sim.make_step()
    assert step.path == "push2d"
    rows = []
    for k in range(100):
        state = step(state)
        if (k + 1) % 10 == 0:
            rows.append([k + 1] + list(sim.energies(state).double().numpy()))
    got = np.asarray(rows)
    assert got.shape == gold.shape
    np.testing.assert_array_equal(got[:, 0], gold[:, 0])
    scale = gold[:, 1:].max()   # absolute floor vs the dominant energy
    for c, name in enumerate(COLS):
        g = gold[:, 1 + c]
        v = got[:, 1 + c]
        err = np.abs(v - g) / np.maximum(np.abs(g), 1e-5 * scale)
        assert err.max() < RTOL[name], (
            f"column {name}: max rel err {err.max():.2e} > {RTOL[name]}")


def test_weibel_small_matches_jax():
    kw = dict(nx=8, ny=8, nppc=8, Lx=4.0, Ly=4.0, seed=3)
    sj = weibel_jax.build(weibel_jax.WeibelParams(**kw))
    sj.use_pallas = False
    st = weibel_torch.build(weibel_torch.WeibelParams(**kw), device="cpu")
    a = sj.initialize()
    adv = jax.jit(sj.make_advance())
    b = st.initialize()
    step = st.make_step()
    for _ in range(10):
        a, b = adv(a), step(b)
    for n in ("jfx", "ex", "ey", "cbz"):
        x = np.asarray(getattr(a.fields, n))
        assert np.abs(x - np_(getattr(b.fields, n))).max() < \
            5e-7 + 1e-5 * np.abs(x).max(), n
    e_a = np.asarray(sj._energies_local(a.fields, a.species), np.float64)
    e_b = st.energies(b).double().numpy()
    assert np.abs(e_a - e_b).max() / e_a.sum() < 1e-6
