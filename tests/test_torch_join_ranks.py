"""join_domain between ranks on the port (tests/test_join_domain.py): the
(4, 1, 1) x ring re-spliced into two independent 2-rank rings must evolve
like two standalone (2, 1, 1) periodic runs of the same halves, with an
exact per-ring census; and the table editing is vpic_tpu's, reciprocal
and free of stale links."""

import numpy as np

import vpic_tpu as vt
import vpic_tpu_torch as vtt
from vpic_tpu_torch.scripts import sharded_checks as SC
from torch_parity import launch_cpu


def _parts(seed, n, Lx):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, Lx, n)
    y = rng.uniform(0, 1.0, n)
    ux = rng.choice([-0.5, 0.5], n) + rng.normal(0, 0.05, n)
    uy = rng.normal(0, 0.1, n)
    return list(zip(x, y, ux, uy))


def _build(pkg, gnx, topo, Lx, part_sets, **kw):
    sim = pkg.Simulation(seed=0, **kw)
    sim.define_units(1.0, 1.0)
    g0 = pkg.partition_periodic_box(0, 0, 0, Lx, 1.0, 0.125, gnx, 8, 1)
    sim.define_timestep(0.7 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (Lx, 1.0, 0.125), (gnx, 8, 1),
                             topo)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    ele = sim.define_species("electron", -1.0, 1.0, 1024)
    for off, parts in part_sets:
        for x, y, ux, uy in parts:
            sim.inject_particle(ele, x + off, y, 0.0625, ux, uy, 0.0, w=1.0)
    return sim


PA, PB = _parts(1, 180, 2.0), _parts(2, 180, 2.0)


def _rings(n_steps):
    """The joined (4, 1, 1) deck on this rank: (energies after 1 step and
    after 4, ex after 4, lanes after n_steps) -- energies summed over the
    ranks."""
    sim = _build(vtt, 32, (4, 1, 1), 4.0, [(0.0, PA), (2.0, PB)],
                 device="cpu")
    for face, rank, src in ((3, 1, 0), (3, 0, 1), (3, 3, 2), (3, 2, 3)):
        sim.join_domain(face, rank, src)
    assert sim.grid.face_partners[3] == (1, 0, 3, 2)
    return _steps(sim, n_steps)


def _half(which, n_steps):
    sim = _build(vtt, 16, (2, 1, 1), 2.0, [(0.0, (PA, PB)[which])],
                 device="cpu")
    return _steps(sim, n_steps)


def _steps(sim, n_steps):
    state = sim.initialize()
    step = sim.make_step()
    state = step(state)
    e1 = sim.energies(state).double().numpy()
    for _ in range(3):
        state = step(state)
    e4 = sim.energies(state).double().numpy()
    ex4 = state.fields.ex.numpy().copy()   # the step updates it in place
    for _ in range(n_steps - 4):
        state = step(state)
    return (e1, e4, ex4, int(state.species[0].np),
            int(sim.migration["n_dropped"]))


def test_twisted_pairs_match_independent_runs(tmp_path):
    """Each ring of the joined 4-rank mesh tracks a standalone (2, 1, 1)
    run of its half (halo exchange and migration through the join table
    only, nothing leaks between rings) -- tests/test_join_domain.py:57's
    tolerances, at 1 and 4 steps -- and the census holds over 8."""
    a = launch_cpu(_rings, 4, tmp_path, 8)
    b1 = launch_cpu(_half, 2, tmp_path, 0, 4)
    b2 = launch_cpu(_half, 2, tmp_path, 1, 4)
    eb1 = b1[0][0] + b2[0][0]
    np.testing.assert_allclose(a[0][0], eb1, rtol=1e-4,
                               atol=1e-6 * eb1.sum())
    scale = max(np.abs(b1[0][2]).max(), 1e-12)
    for r in range(2):
        np.testing.assert_allclose(a[r][2], b1[r][2], atol=1e-3 * scale,
                                   rtol=1e-2)
        np.testing.assert_allclose(a[2 + r][2], b2[r][2], atol=1e-3 * scale,
                                   rtol=1e-2)
    eb = b1[0][1] + b2[0][1]
    np.testing.assert_allclose(a[0][1], eb, rtol=5e-2, atol=1e-4 * eb.sum())
    census = [r[3] for r in a]
    assert all(r[4] == 0 for r in a)
    assert sum(census) == 360
    assert census[0] + census[1] == 180 and census[2] + census[3] == 180


def test_join_domain_table_editing():
    """Splice and unsplice as vpic_tpu does: reciprocal joins, stale links
    removed, every face table a partial permutation."""
    sims = []
    for pkg in (vt, vtt):
        sim = pkg.Simulation(seed=0)
        sim.define_units(1.0, 1.0)
        g0 = pkg.partition_periodic_box(0, 0, 0, 4.0, 1.0, 0.125, 32, 8, 1)
        sim.define_timestep(0.7 * g0.courant_length())
        sim.define_periodic_grid((0, 0, 0), (4.0, 1.0, 0.125), (32, 8, 1),
                                 (4, 1, 1))
        sim.join_domain(3, 2, 0)
        sims.append(sim)
    fp = sims[1].grid.face_partners
    assert fp == sims[0].grid.face_partners
    assert fp[3][0] == 2 and fp[0][2] == 0
    assert fp[3][1] == -1
    for f in range(6):
        tgts = [v for v in fp[f] if v >= 0]
        assert len(tgts) == len(set(tgts))
    # a P_REMOTE face with an unjoined rank would lose its leavers: refused
    sim = sims[1]
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    try:
        SC.P.check_particle_bcs(sim.grid)
    except ValueError as e:
        assert "unjoined" in str(e)
    else:
        raise AssertionError("an unjoined P_REMOTE face was accepted")
