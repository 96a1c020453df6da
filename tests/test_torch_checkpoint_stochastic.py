"""Checkpoint and restart of stochastic decks, on the CPU: a restart of the
small reconnection deck (residency, T&A ops firing every 2 steps) and of
the emission diode mid-run equals the uninterrupted run bit for bit (the
Simulation's generator rides in the checkpoint); the diag keys, the
collision ops' large-pr tallies included, are those vpic_tpu's
initialize() makes, vpic_tpu restores the port's reconnection checkpoint
and steps it (its general path: counts kept, energies within 1e-2 of the
port's after the same steps, a collision firing between), and
interop.state_from_numpy carries vpic_tpu's tally keys across."""

import jax
import numpy as np
import torch

import vpic_tpu.collision as CJ
from vpic_tpu import checkpoint as CJK
from vpic_tpu.models import reconnection as recon_jax
from vpic_tpu_torch import checkpoint as CK
from vpic_tpu_torch import collision as CT
from vpic_tpu_torch.models import emission, reconnection

from test_torch_checkpoint import assert_states_equal, snapshot
from torch_parity import np_, to_torch

torch.set_num_threads(2)

DECK = dict(nx=16, ny=16, nz=16, nppc=2, Lx=8.0, Ly=8.0, Lz=8.0,
            headroom=6.0, tau_coll_interval=2)


def _run(step, state, n):
    for _ in range(n):
        state = step(state)
    return state


def _with_tally(sim, C):
    """The deck plus an electron hard-sphere op, whose large-pr tally rides
    in the diag."""
    el = sim.species[1].params
    sim.collision_ops.append(C.make_binary_op(
        C.hard_sphere_model(0.05, 0.05), 1, 1, el, el, interval=2))
    return sim


def build(tally=False):
    sim = reconnection.build(reconnection.ReconnectionParams(**DECK),
                             device="cpu")
    return _with_tally(sim, CT) if tally else sim


def test_reconnection_restart_bit_equal(tmp_path):
    sim = build()
    assert sim._residency_mode()[0]
    state = _run(sim.make_step(), sim.initialize(), 3)
    base = CK.checkpt(state, str(tmp_path / "ck"), sim=sim)
    cont = _run(sim.make_step(), snapshot(state), 4)
    sim2 = build()
    back = CK.restore(base, sim=sim2)
    assert_states_equal(back, state)
    rerun = _run(sim2.make_step(), back, 4)
    assert_states_equal(rerun, cont)
    assert sim2.relayouts == 2          # steps 4 and 6 fire


def test_emission_restart_bit_equal(tmp_path):
    p = emission.EmissionParams(nx=16, ny=4, Lx=0.5, Ly=0.125)
    sim = emission.build(p, device="cpu")
    state = _run(sim.make_step(), sim.initialize(), 5)
    base = CK.checkpt(state, str(tmp_path / "ck"), sim=sim)
    cont = _run(sim.make_step(), snapshot(state), 5)
    sim2 = emission.build(p, device="cpu")
    rerun = _run(sim2.make_step(), CK.restore(base, sim=sim2), 5)
    assert_states_equal(rerun, cont)
    assert int(cont.species[0].np) > int(state.species[0].np)


def test_jax_restores_the_port_checkpoint_and_steps_it(tmp_path):
    st = build(tally=True)
    sj = _with_tally(recon_jax.build(recon_jax.ReconnectionParams(**DECK)),
                     CJ)
    key = "coll_large_pr:hard sphere:1:1"
    b = _run(st.make_step(), st.initialize(), 3)
    assert key in b.diag and b.diag[key].dtype == torch.int32
    base = CK.checkpt(b, str(tmp_path / "ck"), sim=st)
    sj.use_pallas = True
    want = sj.initialize().diag
    data = np.load(base + ".npz")
    got = {k[len("diag::"):]: data[k] for k in data.files
           if k.startswith("diag::")}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == np.shape(v) and got[k].dtype == np.asarray(
            v).dtype, k
    sj.use_pallas = False
    a = CJK.restore(base, sim=sj)
    assert int(a.step) == 3 and a.diag.keys() == want.keys()
    adv = jax.jit(sj.make_advance())
    a = _run(adv, a, 2)                  # step 4 fires
    b = _run(st.make_step(), b, 2)
    for spj, spt in zip(a.species, b.species):
        assert int(np.asarray(spj.live).sum()) == int(spt.np) == int(
            spt.live.sum())
    e_j = st.energies(to_torch(a)).double().numpy()
    e_t = st.energies(b).double().numpy()
    assert np.isfinite(e_j).all()
    assert abs(e_j.sum() - e_t.sum()) / e_t.sum() < 1e-2
    assert int(a.diag[key]) >= 0


def test_interop_carries_the_tally_keys():
    sj = _with_tally(recon_jax.build(recon_jax.ReconnectionParams(**DECK)),
                     CJ)
    a = sj.initialize()
    b = to_torch(a)
    key = "coll_large_pr:hard sphere:1:1"
    assert key in b.diag and b.diag[key].dtype == torch.int32
    assert int(np_(b.diag[key])) == int(a.diag[key])
