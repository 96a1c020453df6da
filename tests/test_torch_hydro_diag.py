"""The port's hydro moments and field diagnostics (vpic_tpu_torch/ops/
hydro.py, diagnostics.py) on the CPU, against vpic_tpu on the same state
carried across (interop.state_from_numpy): the initial weibel state
(periodic in x and y) and the small harris state (pec walls in x).  Hydro moments to 1e-5 max|moment| (the port's direct
node scatter sums in another order than the JAX package's cell moments);
the Poynting flux, the Gauss error and the div-B error to 1e-5 relative;
the diagnostics leave the state as it was."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpic_tpu import diagnostics as DJ
from vpic_tpu.models import weibel as weibel_jax
from vpic_tpu.ops import hydro as HJ
from vpic_tpu.ops import interp as IJ
from vpic_tpu_torch import diagnostics as DT
from vpic_tpu_torch.models import weibel as weibel_torch
from vpic_tpu_torch.ops import hydro as HT
from vpic_tpu_torch.ops import interp as IT
from vpic_tpu_torch.state import FIELD_NAMES

from torch_parity import assert_close_rel, build_pair, np_, to_torch

torch.set_num_threads(2)

WEIBEL = dict(nx=8, ny=8, nppc=8, Lx=4.0, Ly=4.0, seed=3)


@pytest.fixture(scope="module", params=["weibel", "harris"])
def pair(request):
    """(jax sim, torch sim, jax state, torch state)."""
    if request.param == "weibel":
        sj = weibel_jax.build(weibel_jax.WeibelParams(**WEIBEL))
        st = weibel_torch.build(weibel_torch.WeibelParams(**WEIBEL),
                                device="cpu")
    else:
        sj, st = build_pair()
    a = sj.initialize()
    return sj, st, a, to_torch(a)


def _jax_hydro(sp, fcoef, g, q, m):
    h = jnp.zeros((g.nv, HJ.N_HYDRO), jnp.float32)
    return HJ.synchronize_hydro(HJ.accumulate_hydro_p(h, sp, fcoef, g, q, m),
                                g)


def test_hydro_matches_jax(pair):
    sj, st, a, b = pair
    g = sj.grid
    fj, ft = IJ.load_interpolator(a.fields, g), IT.load_interpolator(
        b.fields, st.grid)
    for k, s in enumerate(sj.species):
        hj = np.asarray(jax.jit(
            lambda sp, fc: _jax_hydro(sp, fc, g, s.params.q, s.params.m))(
                a.species[k], fj))
        ht = HT.accumulate_hydro_p(torch.zeros((g.nv, HT.N_HYDRO)),
                                   b.species[k], ft, st.grid, s.params.q,
                                   s.params.m)
        ht = np_(HT.synchronize_hydro(ht, st.grid))
        assert np.abs(hj).max() > 0
        for c, name in enumerate(HT.HYDRO_NAMES):
            assert_close_rel(hj[:, c], ht[:, c], 0.0,
                             1e-5 * np.abs(hj).max(), f"{k}.{name}")
        np.testing.assert_allclose(np_(HT.compute_hydro(st, b, k)), ht,
                                   rtol=0, atol=0)


def test_hydro_ignores_dead_slots(pair):
    _, st, _, b = pair
    sp = b.species[0]
    g = st.grid
    fcoef = IT.load_interpolator(b.fields, g)
    dead = sp.replace(live=torch.zeros_like(sp.live),
                      ux=torch.full_like(sp.ux, float("nan")))
    h = HT.accumulate_hydro_p(torch.zeros((g.nv, HT.N_HYDRO)), dead.replace(
        ux=torch.zeros_like(sp.ux)), fcoef, g, -1.0, 1.0)
    assert not h.any()


def test_diagnostics_match_jax(pair):
    """On the state with noise added to E and cB (the initial state is
    cleaned: its residuals are round-off)."""
    sj, st, a, _ = pair
    rng = np.random.default_rng(5)
    noisy = {n: np.asarray(getattr(a.fields, n))
             + 1e-2 * rng.standard_normal(sj.grid.shape).astype(np.float32)
             for n in ("ex", "ey", "cbx", "cbz")}
    a = a.replace(fields=a.fields.replace(
        **{n: jnp.asarray(v) for n, v in noisy.items()}))
    b = to_torch(a)
    before = {n: getattr(b.fields, n).clone() for n in FIELD_NAMES}
    for e0 in (1.0, 2.0):
        assert_close_rel(DJ.poynting_flux(a.fields, sj.grid, e0),
                         DT.poynting_flux(b.fields, st.grid, e0), 1e-5,
                         1e-12, "poynting")
    ge = jax.jit(lambda s: DJ.gauss_error(sj, s))(a)
    assert float(ge) > 1e-3
    assert_close_rel(ge, DT.gauss_error(st, b), 1e-5, 0.0, "gauss")
    assert_close_rel(DJ.div_b_error(a.fields, sj.grid),
                     DT.div_b_error(b.fields, st.grid), 1e-5, 0.0, "divb")
    for n in FIELD_NAMES:
        assert torch.equal(before[n], getattr(b.fields, n)), n
