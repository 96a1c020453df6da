"""Checkpoints across the two packages, on the CPU: a vpic_tpu checkpoint
taken after steps on its fused 2-D path (lanes in periodic ghost cells and
unwrapped-y images) restores into the port with canonical voxels, equal to
the state vpic_tpu's own decode gives; a port checkpoint restores in
vpic_tpu, whose jitted step (the fused path, the Pallas kernel in interpret
mode) runs on it and matches the port's next step to the one-step
tolerances of tests/test_pallas.py:65-72 (offsets and momenta 3e-5,
voxels equal, currents 1e-5 max); the port writes the state key
vpic_tpu's initialize() makes for the same deck."""

import jax
import numpy as np
import pytest
import torch

from vpic_tpu import checkpoint as CJ
from vpic_tpu.models import weibel as weibel_jax
from vpic_tpu.ops.pallas_push import remap_ghost_voxels
from vpic_tpu_torch import checkpoint as CT
from vpic_tpu_torch.models import weibel as weibel_torch
from vpic_tpu_torch.state import FIELD_NAMES, SPECIES_NAMES

from torch_parity import np_

torch.set_num_threads(2)

WEIBEL = dict(nx=8, ny=8, nppc=4, Lx=4.0, Ly=4.0, seed=3)


@pytest.fixture(scope="module")
def jax_run():
    """vpic_tpu's weibel deck on its fused path, its jitted step, the
    state after 3 steps and the key its initialize() made."""
    sim = weibel_jax.build(weibel_jax.WeibelParams(**WEIBEL))
    assert sim._fused_mode()[1]
    adv = jax.jit(sim.make_advance())
    state = sim.initialize()
    key0 = np.asarray(state.rng)
    for _ in range(3):
        state = adv(state)
    return sim, adv, state, key0


def test_jax_fused_checkpoint_restores_canonical(jax_run, tmp_path):
    sj, _, a, _ = jax_run
    base = CJ.checkpt(a, str(tmp_path / "ck"), sim=sj)
    st = weibel_torch.build(weibel_torch.WeibelParams(**WEIBEL),
                            device="cpu")
    b = CT.restore(base, sim=st)
    assert b.step == 3 and b.diag.keys() == {"unfinished"}
    assert int(b.diag["unfinished"]) == 0
    np.testing.assert_array_equal(b.rng, np.asarray(a.rng))
    for n in FIELD_NAMES:
        np.testing.assert_array_equal(np_(getattr(b.fields, n)),
                                      np.asarray(getattr(a.fields, n)))
    g = st.grid
    moved = 0
    for spj, spt in zip(a.species, b.species):
        dec = remap_ghost_voxels(spj, sj.grid)
        for n in SPECIES_NAMES:
            np.testing.assert_array_equal(np_(getattr(spt, n)),
                                          np.asarray(getattr(dec, n)), n)
        moved += int((np.asarray(spj.i) != np.asarray(dec.i)).sum())
        i, live = np_(spt.i)[np_(spt.live)], np_(spt.live)
        z, r = np.divmod(i, g.NX * g.NY)
        y, x = np.divmod(r, g.NX)
        assert (z == 1).all() and (1 <= x).all() and (x <= g.nx).all() \
            and (1 <= y).all() and (y <= g.ny).all()
        assert live.sum() == int(spt.np)
    assert moved > 0          # the fused path left ghost / image lanes
    # and the port steps on from it
    nxt = st.make_step()(b)
    assert nxt.step == 4 and int(nxt.diag["unfinished"]) == 0


def test_port_checkpoint_steps_in_jax(jax_run, tmp_path):
    sj, adv, _, key0 = jax_run
    st = weibel_torch.build(weibel_torch.WeibelParams(**WEIBEL),
                            device="cpu")
    b = st.initialize()
    np.testing.assert_array_equal(b.rng, key0)
    step = st.make_step()
    for _ in range(3):
        b = step(b)
    base = CT.checkpt(b, str(tmp_path / "ck"), sim=st)
    data = np.load(base + ".npz")
    assert not [k for k in data.files if k.startswith("diag::")]
    a = CJ.restore(base, sim=sj)
    assert int(a.step) == 3 and a.diag == {}
    a = adv(a)
    b = step(b)                      # step 3: no sort in either package
    live = np_(b.species[0].live)
    for spj, spt in zip(a.species, b.species):
        spj = remap_ghost_voxels(spj, sj.grid)
        live = np_(spt.live)
        np.testing.assert_array_equal(np.asarray(spj.live), live)
        np.testing.assert_array_equal(np.asarray(spj.i)[live],
                                      np_(spt.i)[live])
        for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
            np.testing.assert_allclose(np.asarray(getattr(spj, n))[live],
                                       np_(getattr(spt, n))[live], atol=3e-5)
    for n in ("jfx", "jfy", "jfz"):
        x = np.asarray(getattr(a.fields, n))
        assert np.abs(x - np_(getattr(b.fields, n))).max() < \
            1e-5 * max(np.abs(x).max(), 1e-3), n
