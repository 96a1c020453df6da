"""The collisional reconnection deck in the port (models/reconnection.py,
collisions in the step) against vpic_tpu on the CPU.

* The slice as a whole, its deterministic part: the deck at 16^3 x 8 ppc
  with tau_coll_interval 0 (the three T&A ops present, never firing;
  residency on) for 10 steps against vpic_tpu's deck on its general path,
  to the ten-step tolerances of tests/test_pallas.py:88-94 (fields
  5e-7 + 1e-5 max|a|, energies 1e-6 of their sum), live counts and voxel
  multisets equal.
* The step-0 firing of the three ops, chained as the step chains them
  (each JAX op hands the next its key), on the initialized state of both
  packages with the variates jax.random makes: live masks, voxels and
  weights equal, momenta to 1e-5 max|u| (the inter-species scatter-adds).
* tests/test_inject_reconnection.py's oracle on the port's generator
  (8 x 8 x 4, the general path: energy within 3e-2 over 10 steps, counts
  kept); the residency step rebuckets before the push exactly on the
  firing steps; the residency decision equals vpic_tpu's; and a 2-D harris
  deck with a T&A op on the 2-D kernel path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu_torch.collision as CT
from vpic_tpu import emitter as EJ
from vpic_tpu.models import reconnection as recon_jax
from vpic_tpu_torch import emitter as ET
from vpic_tpu_torch.models import harris, reconnection

from test_torch_collision import assert_species_match, binary_draws
from torch_parity import assert_close_rel, np_, to_torch

torch.set_num_threads(2)

DECK16 = dict(nx=16, ny=16, nz=16, nppc=8, Lx=8.0, Ly=8.0, Lz=8.0,
              headroom=6.0)
ORACLE = dict(nx=8, ny=8, nz=4, Lx=4.0, Ly=4.0, Lz=2.0, nppc=8,
              tau_coll_interval=5, coll_n0=0.02)


def pair(**kw):
    p = dict(DECK16, **kw)
    return (recon_jax.build(recon_jax.ReconnectionParams(**p)),
            reconnection.build(reconnection.ReconnectionParams(**p),
                               device="cpu"))


def test_never_firing_deck_matches_jax():
    sj, st = pair(tau_coll_interval=0)
    sj.use_pallas = False
    assert st._residency_mode()[0] and len(st.collision_ops) == 3
    assert st.make_step().path == "push3d"
    s_j = sj.initialize()
    adv = jax.jit(sj.make_advance())
    s_t = st.initialize()
    energies = lambda s: st.energies(s).double().numpy()
    step = st.make_step()
    for _ in range(10):
        s_j = adv(s_j)
        s_t = step(s_t)
    for n in ("jfx", "jfy", "jfz", "ex", "ey", "cbz"):
        assert_close_rel(getattr(s_j.fields, n), getattr(s_t.fields, n),
                         1e-5, 5e-7, n)
    e_j = energies(to_torch(s_j))
    assert np.abs(e_j - energies(s_t)).max() / e_j.sum() < 1e-6
    for a, b in zip(s_j.species, s_t.species):
        la, lb = np.asarray(a.live), np_(b.live)
        assert la.sum() == lb.sum() == int(b.np)
        assert np.array_equal(np.sort(np.asarray(a.i)[la]),
                              np.sort(np_(b.i)[lb]))
    assert st.relayouts == 1 and int(s_t.diag["_res_rebuckets"]) == 0
    assert int(s_t.diag["unfinished"]) == 0


def test_step0_firing_matches_jax():
    sj, st = pair(nx=8, ny=8, nz=8, nppc=16, Lx=4.0, Ly=4.0, Lz=4.0,
                  tau_coll_interval=5, coll_n0=0.5)
    s_j = sj.initialize()
    species_j = list(s_j.species)
    species_t = list(to_torch(s_j).species)
    caps = [sp.capacity for sp in species_t]
    key, diag = s_j.rng, {}
    # ion-ion, electron-electron, electron-ion (models/reconnection.py)
    for (i, j), op_j, op_t in zip(((0, 0), (1, 1), (1, 0)),
                                  sj.collision_ops, st.collision_ops):
        draws = binary_draws(key, 0, (caps[i], caps[j]), i == j, 1,
                             "normal")
        species_j, key, diag = op_j(species_j, s_j.fields, sj.grid,
                                    jnp.int32(0), key, diag)
        species_t, n = op_t.apply(species_t, st.grid, draws)
        assert int(n) == 0
    assert diag == {}
    for k in range(2):
        assert_species_match(species_j[k], species_t[k], f"species {k}")
        assert not np.array_equal(np.asarray(species_j[k].ux),
                                  np.asarray(s_j.species[k].ux))


def test_collisional_reconnection_3d():
    """tests/test_inject_reconnection.py:48-64 on the port."""
    sim = reconnection.build(reconnection.ReconnectionParams(**ORACLE),
                             device="cpu")
    assert sim.make_step().path == "general"
    state = sim.initialize()
    step = sim.make_step()
    e0 = sim.energies(state).double().numpy()
    u0 = state.species[1].ux.clone()
    for _ in range(10):
        state = step(state)
    e1 = sim.energies(state).double().numpy()
    assert abs(e1.sum() - e0.sum()) / e0.sum() < 3e-2
    for st, sp in zip(sim.species, state.species):
        assert int(sp.np) == st.count == int(sp.live.sum())
    assert not torch.equal(u0, state.species[1].ux)


def test_residency_rebuckets_exactly_on_the_firing_steps():
    sim = reconnection.build(reconnection.ReconnectionParams(
        **dict(DECK16, nppc=2, tau_coll_interval=3)), device="cpu")
    assert sim._residency_mode()[0]
    state = sim.initialize()
    step = sim.make_step()
    n0 = [st.count for st in sim.species]
    seen = []
    for k in range(7):
        before = sim.relayouts
        state = step(state)
        seen.append(sim.relayouts - before)
        assert [int(sp.np) for sp in state.species] == n0
    assert seen == [1 if k % 3 == 0 else 0 for k in range(7)]
    assert sim.host_syncs == 7 and int(state.diag["unfinished"]) == 0


@pytest.mark.parametrize("case", ["tau5", "tau1", "tau0", "emitter",
                                  "injection", "collisions"])
def test_residency_mode_matches_jax(case):
    tau = {"tau1": 1, "tau0": 0}.get(case, 5)
    sj, st = pair(nppc=2, tau_coll_interval=tau)
    sj.use_pallas = True
    for sim, E in ((sj, EJ), (st, ET)):
        if case == "emitter":
            sim.define_surface_emitter(E.child_langmuir,
                                       lambda x, y, z: x < 0,
                                       sim.species[1].params)
        elif case == "injection":
            sim.user_particle_injection = lambda *a: a
        elif case == "collisions":
            sim.user_particle_collisions = lambda *a: a
    want = sj._residency_mode()
    assert st._residency_mode() == want
    assert want[0] == (case in ("tau5", "tau0"))


def test_harris2d_with_a_takizuka_abe_op():
    """The 2-D kernel path with collisions: electron-electron T&A every 2
    steps on a 32^2 harris deck; counts kept, energy within 1e-2 over 12
    steps, the momenta changed against the collisionless run."""
    p = harris.HarrisParams(nx=32, ny=32, nppc=16, Lx=8.0, Ly=8.0)
    runs = []
    for collide in (True, False):
        sim = harris.build(p, device="cpu")
        if collide:
            el = sim.species[1].params
            sim.collision_ops.append(CT.make_takizuka_abe_op(
                1, 1, el, el, sim.grid, n0=5.0, interval=2))
        assert sim.make_step().path == "push2d"
        state = sim.initialize()
        e0 = sim.energies(state).double().numpy()
        step = sim.make_step()
        for _ in range(12):
            state = step(state)
        e1 = sim.energies(state).double().numpy()
        assert abs(e1.sum() - e0.sum()) / e0.sum() < 1e-2
        for st, sp in zip(sim.species, state.species):
            assert int(sp.np) == st.count == int(sp.live.sum())
        runs.append(e1)
    assert not np.array_equal(runs[0], runs[1])
