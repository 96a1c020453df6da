"""Interior region particle surfaces (set_region_particle_bc) through the
port's kernel paths -- their plain versions on the CPU -- against vpic_tpu's
general path (use_pallas=False), on the decks of tests/test_region_pbc.py:
the 2-D interior absorber (:20-53), the corner crossing (:136-176), the
interior tally handler (:111-126), the reflector (:56-60), and the 3-D
interior absorber (:184-230), here on the 3-D residency path.

Survivor counts must be equal, and rhob agree to 1e-6 max|rhob| (the
charge of the same absorbed lanes, deposited in another order); the
per-voxel-face code tables of both packages are equal.

The 2-D decks put a unit-weight electron in a cell of volume 32^-3: the
self-fields are strong, and the rounding difference between XLA's and
torch's float32 ops (1e-7 of ex after one step, the same with the port's
general path) grows about tenfold every three steps, to O(1) of ex by
step 19.  So the fields are compared at step 7 (with the ten-step
tolerances of tests/test_pallas.py:88-94) and the survivors at every step
through step 30; from step 37 the counts part (ROADMAP Queue 3)."""

import numpy as np
import pytest
import torch

import vpic_tpu as vj
import vpic_tpu_torch as vt
from vpic_tpu import boundary_ops as BOJ
from vpic_tpu_torch import boundary_ops as BOT

from torch_parity import assert_close_rel, np_

torch.set_num_threads(2)


def _in_box2(x, y, z):
    return (0.4 < x < 0.6) and (0.4 < y < 0.6)


def build2(pkg, bc, seed=2, n=2000):
    """test_region_pbc.py's build(): a 32^2 periodic box, 2000 electrons
    outside a square region whose surface carries ``bc``."""
    kw = {"device": "cpu"} if pkg is vt else {}
    sim = pkg.Simulation(seed=seed, **kw)
    sim.define_units(1.0, 1.0)
    g0 = pkg.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0 / 32, 32, 32, 1)
    sim.define_timestep(0.7 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 1.0 / 32), (32, 32, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    ele = sim.define_species("electron", -1.0, 1.0, 4096)
    rng = np.random.default_rng(0)
    k = 0
    while k < n:
        x, y = rng.uniform(0, 1), rng.uniform(0, 1)
        u = rng.normal(0, 0.3, 3)
        if 0.4 < x < 0.6 and 0.4 < y < 0.6:
            continue                      # never start inside the region
        sim.inject_particle(ele, x, y, 1.0 / 64, *u, w=1.0)
        k += 1
    sim.set_region_particle_bc(_in_box2, bc)
    if pkg is vj:
        sim.use_pallas = False
    return sim


def run(sim, n_steps):
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(n_steps):
        state = step(state)
    return state


def live_count(state):
    return int(np.asarray(np_(state.species[0].live)).sum())


FIELD_STEPS = 7
COUNT_STEPS = 30


def run_both(sj, st):
    """Step both decks COUNT_STEPS times, survivors equal at every step;
    the fields at FIELD_STEPS within 5e-7 + 1e-5 max|a| (rhob 1e-6).
    Returns the final states."""
    a, b = sj.initialize(), st.initialize()
    rb0 = float(np.asarray(a.fields.rhob).sum())
    sa, sb = sj.make_step(), st.make_step()
    for k in range(1, COUNT_STEPS + 1):
        a, b = sa(a), sb(b)
        assert live_count(a) == live_count(b), f"step {k}"
        if k == FIELD_STEPS:
            for n in ("ex", "ey", "jfx", "cbz"):
                x = np.asarray(getattr(a.fields, n))
                assert np.abs(x - np_(getattr(b.fields, n))).max() < \
                    5e-7 + 1e-5 * np.abs(x).max(), n
            assert_close_rel(np.asarray(a.fields.rhob), b.fields.rhob, 1e-6,
                             0.0, "rhob")
    # every absorbed electron's charge is in rhob: the same total
    absorbed = 2000 - live_count(b)
    for s in (a, b):
        per = (float(np.asarray(np_(s.fields.rhob)).sum()) - rb0) / absorbed
        g = st.grid
        assert -4.0 / g.dV < per < -0.5 / g.dV
    return a, b


def test_interior_absorber_2d_matches_general_path():
    sj = build2(vj, vj.ABSORB_PARTICLES)
    st = build2(vt, vt.ABSORB_PARTICLES)
    np.testing.assert_array_equal(sj._vbc, st._vbc)
    assert st.make_step().path == "push2d"
    a, b = run_both(sj, st)
    assert live_count(b) < 2000 - 5, "interior absorber never fired"
    assert int(b.species[0].np) == live_count(b)
    # nobody inside the region
    g = st.grid
    live = np_(b.species[0].live)
    vox = np_(b.species[0].i)[live]
    zi, r = np.divmod(vox, g.sz)
    yi, xi = np.divmod(r, g.sy)
    inside = ((xi - 0.5) * g.dx > 0.4 + g.dx) & \
        ((xi - 0.5) * g.dx < 0.6 - g.dx) & \
        ((yi - 0.5) * g.dy > 0.4 + g.dy) & ((yi - 0.5) * g.dy < 0.6 - g.dy)
    assert not inside.any()


def test_interior_reflector_keeps_particles():
    state = run(build2(vt, vt.REFLECT_PARTICLES), 40)
    assert live_count(state) == 2000 == int(state.species[0].np)


def test_interior_handler_tally_matches_general_path():
    """absorb_tally on a region surface: parked with pend CUSTOM_BASE + 6 +
    6h + face and dispatched by boundary_p; the port's tallies add up to
    its losses, face by face as vpic_tpu's."""
    sj = build2(vj, BOJ.absorb_tally())
    st = build2(vt, BOT.absorb_tally())
    assert sorted(st.pbc_handlers) == sorted(sj.pbc_handlers) == \
        list(range(6, 12))
    a, b = run_both(sj, st)
    lost = 2000 - live_count(b)
    assert lost > 5
    tj = [BOJ.tally_of(a.diag, "electron", 6 + f) for f in range(6)]
    tt = [BOT.tally_of(b.diag, "electron", 6 + f) for f in range(6)]
    assert sum(tt) == lost and tt == tj


def test_corner_crossing_hits_interior_surface():
    """A lane crossing +x then +y in one step passes through the cell
    bordering the region corner and must see the region face on the second
    crossing: the kernel path reads the face's rule where the walk meets
    it, as the general path does."""
    outs = []
    for pkg in (vj, vt):
        kw = {"device": "cpu"} if pkg is vt else {}
        sim = pkg.Simulation(seed=3, **kw)
        sim.define_units(1.0, 1.0)
        g0 = pkg.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0 / 32,
                                        32, 32, 1)
        sim.define_timestep(0.7 * g0.courant_length())
        sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 1.0 / 32),
                                 (32, 32, 1))
        sim.define_material("vacuum", 1.0)
        sim.define_field_array(damp=0.0)
        ele = sim.define_species("electron", -1.0, 1.0, 1024)
        dx = 1.0 / 32
        x0 = 0.5 - 1.5 * dx     # two cells left of and below the region
        sim.inject_particle(ele, x0 + 0.45 * dx, x0 + 0.40 * dx, 1 / 64,
                            8.0, 9.0, 0.0, w=1.0)   # fast, +x +y
        sim.set_region_particle_bc(
            lambda x, y, z: (0.5 < x < 0.5625) and (0.5 < y < 0.5625),
            pkg.ABSORB_PARTICLES)
        if pkg is vj:
            sim.use_pallas = False
        outs.append(live_count(run(sim, 12)))
    assert outs[0] == outs[1]


def _in_box3(x, y, z):
    return (0.375 < x < 0.625) and (0.375 < y < 0.625) and \
        (0.375 < z < 0.625)


def build3(pkg, capacity):
    """test_region_pbc.py's 3-D deck: a 16^3 periodic box, 300 electrons
    outside a cubic absorbing region."""
    kw = {"device": "cpu"} if pkg is vt else {}
    sim = pkg.Simulation(seed=5, **kw)
    sim.define_units(1.0, 1.0)
    g0 = pkg.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0, 16, 16, 16)
    sim.define_timestep(0.7 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 1.0), (16, 16, 16))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    ele = sim.define_species("electron", -1.0, 1.0, capacity)
    rng = np.random.default_rng(1)
    k = 0
    while k < 300:
        x, y, z = rng.uniform(0, 1, 3)
        if _in_box3(x, y, z):
            continue                      # never start inside the region
        sim.inject_particle(ele, x, y, z, *rng.normal(0, 0.3, 3), w=1.0)
        k += 1
    sim.set_region_particle_bc(_in_box3, pkg.ABSORB_PARTICLES)
    if pkg is vj:
        sim.use_pallas = False
    return sim


@pytest.mark.parametrize("capacity,residency", [(2048, False),
                                                (20480, True)])
def test_interior_absorber_3d_matches_general_path(capacity, residency):
    """The 3-D kernel path, per-step brick sort and residency, tracks
    vpic_tpu's general path: the same survivors, rhob within 1e-6."""
    sj = build3(vj, capacity)
    st = build3(vt, capacity)
    assert st.make_step().path == "push3d"
    assert st._residency_mode()[0] == residency
    n_steps = 4
    a, b = run(sj, n_steps), run(st, n_steps)
    assert live_count(b) < 300, "interior absorber never fired"
    assert live_count(a) == live_count(b)
    assert_close_rel(np.asarray(a.fields.rhob), b.fields.rhob, 1e-6, 0.0,
                     "rhob")
    if residency:
        assert int(b.diag["_res_rebuckets"]) == 0
