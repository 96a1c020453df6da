"""The graph-safe step, the cadence a graph is captured for, and the
graphed step's refusals, on the CPU (the graphs themselves run on the card:
tests/test_torch_cuda_graph.py and chip_smoke.py phase 29).

* Every tensor the state carries (fields, lanes, np, diag) keeps its
  storage from step to step, and the step returns the state's own objects:
  harris 2-D through a bucket sort, 3-D residency harris through a forced
  rebucket, force_free (a brick sort every step), the emission diode and a
  small reconnection deck (a firing and its relayout).
* step_graph.refusal names the CPU, a decomposed grid, each of the four
  hooks, a collision op without a cadence, and the hooks of lpi, dipole,
  waveguide and cygnus (every other one-domain deck is captured).
* The cadence the step is captured for equals the branches the eager
  step takes, for steps 0-48 of harris 2-D and reconnection.
* make_multi_step(10) against vpic_tpu's (one lax.scan, the Pallas kernels
  in interpret mode) on 2-D harris at 16^2 x 16 ppc and on 3-D residency
  harris at 16^3, to tests/test_pallas.py:88-94's ten-step tolerance
  (fields to 5e-7 + 1e-5 max|a|), energies to 1e-6 of their sum in 2-D
  (test_pallas.py:94-96) and to 2e-5 of the largest in 3-D (the residency
  pair's, tests/test_residency.py:37-42), live counts equal.  The JAX
  side's compile of the scanned step takes most of this file's time."""

import jax
import numpy as np
import pytest
import torch

from vpic_tpu_torch.state import FIELD_NAMES
from vpic_tpu.models import harris as harris_jax
from vpic_tpu_torch import step_graph as SG
from vpic_tpu_torch.models import emission, force_free, harris, lpi, \
    reconnection
from vpic_tpu_torch.scripts import graph_checks as GC

torch.set_num_threads(2)

H2 = dict(nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0)
H3 = dict(nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0)
RECON = dict(nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0,
             headroom=3.0, tau_coll_interval=5)

DECKS = {
    "harris2d": (lambda: harris.build(harris.HarrisParams(**H2),
                                      device="cpu"), 10),
    "residency3d": (lambda: harris.build(harris.HarrisParams(
        headroom=3.0, **H3), device="cpu"), 4),
    "force_free": (lambda: force_free.build(force_free.ForceFreeParams(
        nx=16, ny=8, nz=8, nppc=2), device="cpu"), 3),
    "emission": (lambda: emission.build(emission.EmissionParams(
        nx=16, ny=4, Lx=0.5, Ly=0.125), device="cpu"), 5),
    "reconnection": (lambda: reconnection.build(
        reconnection.ReconnectionParams(**RECON), device="cpu"), 6),
}


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_step_keeps_the_state_storage(deck):
    make, n = DECKS[deck]
    sim = make()
    state = sim.initialize()
    step = sim.make_step()
    assert step.graphed == "eager: device cpu: CUDA graphs need the card"
    before = GC.storage(state)
    objects = (state.fields, state.species)
    rebuckets = 0
    for k in range(n):
        if deck == "residency3d" and k == 2:
            # the layout is set: the next push overflows an outbox
            rebuckets = int(state.diag["_res_rebuckets"])
            assert GC.force_rebucket(sim, state) > 128
        out = step(state)
        assert out.step == state.step + 1
        assert (out.fields, out.species) == objects
        assert all(a is b for a, b in zip(out.species, objects[1]))
        assert GC.storage(out) == before
        state = out
    if deck == "residency3d":
        assert int(state.diag["_res_rebuckets"]) > rebuckets
        sp = state.species[0]
        assert int(sp.np) == int(sp.live.sum()) == 8192
    assert int(state.diag["unfinished"]) == 0
    assert np.isfinite(sim.energies(state).numpy()).all()


def _deck(**hooks):
    sim = harris.build(harris.HarrisParams(**H2), device="cuda")
    for k, v in hooks.items():
        setattr(sim, k, v)
    return sim


def test_refusal_reasons():
    assert SG.refusal(_deck()) is None
    cpu = harris.build(harris.HarrisParams(**H2), device="cpu")
    assert SG.refusal(cpu) == "device cpu: CUDA graphs need the card"
    assert SG.refusal(harris.build(harris.HarrisParams(
        topology=(1, 2, 1), **H2), device="cuda")) == (
        "decomposed grid: its exchanges and migration counts are host "
        "round trips")
    hook = lambda *a: a[0]
    for name in SG.HOOKS:
        assert SG.refusal(_deck(**{name: hook})) == \
            f"{name} takes the host step"
    both = SG.refusal(_deck(user_field_injection=hook,
                            user_particle_injection=hook))
    assert both == ("user_field_injection takes the host step; "
                    "user_particle_injection takes the host step")
    custom = _deck()
    custom.collision_ops.append(lambda sp, f, g, step, gen: sp)
    assert SG.refusal(custom) == \
        "collision op 0 has no interval: its firing is not known"
    assert SG.refusal(lpi.build(lpi.LPIParams(), device="cuda")) == \
        "user_field_injection takes the host step"
    # the eager step a refused deck makes says why
    step = lpi.build(lpi.LPIParams(), device="cpu").make_step()
    assert step.graphed == ("eager: device cpu: CUDA graphs need the card; "
                            "user_field_injection takes the host step")
    many = cpu.make_multi_step(3)
    assert (many.graphed, many.path, many.fields) == (
        "eager: device cpu: CUDA graphs need the card", "push2d",
        "field_beb")


def test_one_domain_decks_refused_for_their_hooks():
    """Of the port's sixteen one-domain decks, built for the card (nothing
    touches it), lpi, dipole, waveguide and cygnus run eagerly, each for
    the hook that reads the host step; the others are captured."""
    refused = {k: v for k, v in GC.refusals().items() if v}
    assert refused == {
        "lpi": "user_field_injection takes the host step",
        "dipole": "user_current_injection takes the host step",
        "waveguide": "user_field_injection takes the host step",
        "cygnus": "user_field_injection takes the host step"}


@pytest.mark.parametrize("deck", ["harris2d", "reconnection"])
def test_cadence_is_the_branches_taken(deck):
    sim = (harris.build(harris.HarrisParams(**H2), device="cpu")
           if deck == "harris2d" else
           reconnection.build(reconnection.ReconnectionParams(**RECON),
                              device="cpu"))
    trace = GC.cadence_trace(sim, 49)
    cadences = set()
    for step, (cad, took) in enumerate(trace):
        cadences.add(cad)
        assert cad.sort == took["sort"], step
        assert cad.clean_e == took["clean_e"], step
        assert cad.clean_b == took["clean_b"], step
        assert cad.sync == took["sync"], step
        assert cad.relayout == took["relayout"], step
        assert any(cad.fire) == took["drew"], step
    if deck == "harris2d":
        # the sort every 8 steps, the cleaners every status_interval
        assert sim.status_interval == 12 and len(cadences) == 4
        assert [s for s, (c, _) in enumerate(trace) if c.sort] == \
            list(range(0, 49, 8))
    else:
        fired = [s for s, (c, _) in enumerate(trace) if any(c.fire)]
        assert fired == list(range(0, 49, 5))
        # the relayout: the first step and every firing
        assert [s for s, (c, _) in enumerate(trace) if c.relayout] == fired


def _jax_pair(params):
    sj = harris_jax.build(harris_jax.HarrisParams(**params))
    sj.use_pallas = True
    st = harris.build(harris.HarrisParams(**params), device="cpu")
    return sj, st


@pytest.mark.parametrize("dims", ["2d", "3d"])
def test_multi_step_matches_jax_scan(dims):
    params = (dict(H2, nppc=16) if dims == "2d"
              else dict(H3, headroom=6.0))
    sj, st = _jax_pair(params)
    if dims == "3d":
        sj.pallas_residency = True
        assert st._residency_mode()[0]
    s_j = sj.make_multi_step(10)(sj.initialize())
    many = st.make_multi_step(10)
    s_t = many(st.initialize())
    assert s_t.step == 10 and int(np.max(np.asarray(s_j.step))) == 10
    for n in ("jfx", "ex", "ey", "cbz"):
        a = np.asarray(getattr(s_j.fields, n))
        b = getattr(s_t.fields, n).numpy()
        assert np.abs(a - b).max() < 5e-7 + 1e-5 * np.abs(a).max(), n
    e_j = np.asarray(sj.energies(s_j), np.float64)
    e_t = st.energies(s_t).double().numpy()
    if dims == "2d":
        assert np.abs(e_j - e_t).max() / e_j.sum() < 1e-6
    else:
        # the 3-D residency pair's (tests/test_residency.py:37-42)
        assert np.abs(e_j - e_t).max() / np.abs(e_j).max() < 2e-5
    for a, b in zip(s_j.species, s_t.species):
        assert int(np.asarray(a.live).sum()) == int(b.live.sum())


def test_multi_step_is_single_steps_after_a_restore_point():
    """make_multi_step from a state mid-run equals the same steps one at a
    time, bit for bit, and leaves the state's storage where it was."""
    runs = []
    for multi in (False, True):
        sim = harris.build(harris.HarrisParams(**H2), device="cpu")
        state = sim.make_multi_step(5)(sim.initialize())
        ptrs = GC.storage(state)
        if multi:
            state = sim.make_multi_step(7)(state)
        else:
            step = sim.make_step()
            for _ in range(7):
                state = step(state)
        assert GC.storage(state) == ptrs and state.step == 12
        runs.append(state)
    assert GC.lanes_equal(*runs) == []
    assert GC.fields_close(*runs, names=FIELD_NAMES) == 0.0
