"""Decomposed decks on the port held to vpic_tpu's own tests' assertions,
one Gloo rank per domain on the CPU: the pcomm round trip on (2, 2, 2)
(tests/test_sharded.py:66-125), lpi on (2, 2, 1) against one domain
(tests/test_sample_decks.py:129-151), and the dry run's (2, 2, 2) 3-D box
(vpic_tpu/parallel/mesh.py:153-176)."""

import numpy as np

import vpic_tpu_torch as vtt
from vpic_tpu_torch.scripts import sharded_checks as SC
from torch_parity import launch_cpu


def _run(sim, n_steps):
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(n_steps):
        state = step(state)
    return state


def _total_np(state):
    return int(sum(int(sp.np) for sp in state.species))


STARTS = [(0.3, 0.4, 0.6), (0.7, 0.2, 0.9), (0.12, 0.55, 0.31)]


def _pcomm():
    """tests/test_sharded.py:66-125 on the port: this rank's lanes' global
    positions after a full periodic transit on (2, 2, 2)."""
    n, ns = 8, 2
    sim = vtt.Simulation(seed=0, device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04)
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 1.0),
                             (n * ns, n * ns, n * ns), (ns, ns, ns))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.num_comm_round = 1
    spc = sim.define_species("test", 1e-30, 1.0, 4096, -1, 0, 1)
    v = 0.5
    u = v / np.sqrt(1 - v * v)
    for (x, y, z) in STARTS:
        sim.inject_particle(spc, x, y, z, u, 0, 0, 1.0)
        sim.inject_particle(spc, x, y, z, 0, -u, 0, 1.0)
        sim.inject_particle(spc, x, y, z, 0, 0, u, 1.0)
    state = _run(sim, 50)
    g = sim.grid
    sx, sy, sz = vtt.grid.rank_coords(g, vtt.grid.flat_rank(g))
    sp = state.species[0]
    live = sp.live.numpy()
    zi, r = np.divmod(sp.i.numpy()[live], g.sz)
    yi, xi = np.divmod(r, g.sy)
    x = g.x0 + (sx * g.nx + xi - 1) * g.dx + (sp.dx.numpy()[live] + 1) \
        * 0.5 * g.dx
    y = g.y0 + (sy * g.ny + yi - 1) * g.dy + (sp.dy.numpy()[live] + 1) \
        * 0.5 * g.dy
    z = g.z0 + (sz * g.nz + zi - 1) * g.dz + (sp.dz.numpy()[live] + 1) \
        * 0.5 * g.dz
    return list(zip(x, y, z)), int(sim.migration["n_dropped"])


def test_pcomm_roundtrip_on_ranks(tmp_path):
    """Ballistic lanes crossing rank faces on a (2, 2, 2) periodic mesh
    return to their start after a full transit (50 steps)."""
    res = launch_cpu(_pcomm, 8, tmp_path)
    pos = np.array(sorted(p for r in res for p in r[0]))
    assert all(r[1] == 0 for r in res)
    expect = np.array(sorted([s for s in STARTS for _ in range(3)]))
    np.testing.assert_allclose(pos, expect, atol=2e-3)


def _lpi(topology):
    from vpic_tpu_torch.models import lpi
    sim = lpi.build(lpi.LPIParams(topology=topology), device="cpu")
    st = _run(sim, 10)
    return (sim.energies(st).double().numpy(),
            int(SC.total(_total_np(st), sim.grid)))


def test_lpi_on_ranks_tracks_one_domain(tmp_path):
    """tests/test_sample_decks.py:129-151 on the port: lpi (the laser hook
    on the ix == 0 ranks, absorbing x field faces and reflux x walls on
    the edge ranks) on (2, 2, 1) tracks one domain over 10 steps: the
    census equal, particle energies to 5e-3, the laser's ey and bz to
    5e-2."""
    e1, n1 = _lpi((1, 1, 1))
    for e2, n2 in launch_cpu(_lpi, 4, tmp_path, (2, 2, 1)):
        assert n2 == n1
        np.testing.assert_allclose(e2[6:], e1[6:], rtol=5e-3)
        np.testing.assert_allclose(e2[[1, 5]], e1[[1, 5]], rtol=5e-2)
        assert np.isfinite(e2).all()


def test_chart3d_case_on_eight_ranks(tmp_path):
    """parallel.mesh.chart3d_case: one step of the 32^3 box on (2, 2, 2),
    the 3-D push with home maps on every rank, the 512 lanes kept, the
    summed energies finite and alike on every rank."""
    from vpic_tpu_torch.parallel import mesh as M
    res = launch_cpu(M.chart3d_case, 8, tmp_path, "cpu")
    assert sum(r[0] for r in res) == 512
    assert all(r[1] == "push3d" for r in res)
    assert np.isfinite(res[0][2]).all()
    assert all(np.array_equal(r[2], res[0][2]) for r in res)
