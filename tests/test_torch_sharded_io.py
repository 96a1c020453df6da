"""Decomposed I/O and diagnostics on the port, Gloo ranks of the CPU:
checkpoints read across packages both ways (one file, arrays with the
leading topology dims), remap (1, 2, 1) -> (1, 1, 1)
(tests/test_io_diag.py:273), per-rank dumps stitched by
utilities/read_dumps.py (:355), the Poynting flux's ix == 0 gate
(tests/test_poynting.py), region materials (tests/test_materials.py:79)
and an interior absorber (tests/test_region_pbc.py:126) on decomposed
grids against one domain."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

import vpic_tpu_torch as vtt
from vpic_tpu import checkpoint as CKJ
from vpic_tpu.models import weibel as weibel_jax
from vpic_tpu_torch import checkpoint as CKT
from vpic_tpu_torch import diagnostics as DT
from vpic_tpu_torch import dump as DU
from vpic_tpu_torch.grid import flat_rank, rank_coords
from vpic_tpu_torch.interop import (gather_to_numpy, state_from_numpy,
                                    state_to_numpy)
from vpic_tpu_torch.models import weibel as weibel_torch
from vpic_tpu_torch.scripts import sharded_checks as SC
from torch_parity import launch_cpu

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "utilities"))
import read_dumps as RD  # noqa: E402

WEIBEL = dict(nx=8, ny=8, nppc=4, Lx=4.0, Ly=4.0, seed=3, sort_interval=0)
STEPS = 3


def _weibel(topology, device="cpu"):
    return weibel_torch.build(weibel_torch.WeibelParams(
        **WEIBEL, topology=topology), device=device)


# ---------------- the decks every rank builds ----------------

def _poynting_sim(topo, cvac=2.0):
    sim = vtt.Simulation(seed=0, device="cpu")
    sim.define_units(cvac, 1.0)
    g0 = vtt.partition_periodic_box(0, 0, 0, 1.0, 1.0, 0.5, 8, 8, 4)
    sim.define_timestep(0.5 * g0.courant_length() / cvac)
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 0.5), (8, 8, 4), topo)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    return sim


def _poynting(topo, amp_e, amp_b, prof, e0=1.0):
    """tests/test_poynting.py's plane wave: ey, cbz set from the global
    x index on this rank's brick."""
    sim = _poynting_sim(topo)
    st = sim.initialize()
    g = sim.grid
    sx = rank_coords(g, flat_rank(g))[0]
    for i in range(g.NX):
        st.fields.ey[:, :, i] = amp_e * prof(sx * g.nx + i)
        st.fields.cbz[:, :, i] = amp_b * prof(sx * g.nx + i)
    return float(DT.poynting_flux(st.fields, g, e0=e0))


def _materials_sim(topology):
    n = 8
    sim = vtt.Simulation(seed=0, device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.5 / (n * np.sqrt(3.0)))
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, n), topology)
    sim.define_material("vacuum", 1.0)
    m = sim.define_material("metal", eps=1.0, sigma=20.0)
    sim.define_field_array(damp=0.0)
    sim.set_region_material(lambda x, y, z: 0.4 < x < 0.6, m)
    k = 2 * np.pi * 2
    sim.set_region_field(vtt.everywhere, ey=lambda x, y, z: np.cos(k * x),
                         bz=lambda x, y, z: np.cos(k * x))
    return sim


def _materials(topology, steps=20):
    sim = _materials_sim(topology)
    state = sim.initialize()
    step = sim.make_step()
    hist = [float(sim.energies(state).sum())]
    for _ in range(steps):
        state = step(state)
        hist.append(float(sim.energies(state).sum()))
    return np.array(hist)


def _absorber_sim(topology):
    """tests/test_region_pbc.py:20-44's interior absorbing box."""
    sim = vtt.Simulation(seed=2, device="cpu")
    sim.define_units(1.0, 1.0)
    g0 = vtt.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0 / 32, 32, 32, 1)
    sim.define_timestep(0.7 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 1.0 / 32), (32, 32, 1),
                             topology)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    ele = sim.define_species("electron", -1.0, 1.0, 4096 // topology[1])
    rng = np.random.default_rng(0)
    k = 0
    while k < 2000:
        x, y = rng.uniform(0, 1), rng.uniform(0, 1)
        u = rng.normal(0, 0.3, 3)
        if 0.4 < x < 0.6 and 0.4 < y < 0.6:
            continue
        sim.inject_particle(ele, x, y, 1.0 / 64, *u, w=1.0)
        k += 1
    sim.set_region_particle_bc(
        lambda x, y, z: (0.4 < x < 0.6) and (0.4 < y < 0.6),
        vtt.ABSORB_PARTICLES)
    return sim


def _absorber(topology, n_steps=12):
    sim = _absorber_sim(topology)
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(n_steps):
        state = step(state)
    return int(SC.total(int(state.species[0].np), sim.grid))


def _two_ranks(d, jax_ck):
    """Every (1, 2, 1) case on this rank (see the tests)."""
    out = {}
    # a checkpoint of vpic_tpu's, restored here
    sim = _weibel((1, 2, 1))
    out["from_jax"] = state_to_numpy(CKT.restore(jax_ck, sim=sim))
    # the port's: 3 steps, a checkpoint, the dumps, the gathered state
    sim = _weibel((1, 2, 1))
    st = sim.initialize()
    step = sim.make_step()
    for _ in range(STEPS):
        st = step(st)
    CKT.checkpt(st, os.path.join(d, "ck"), tag="t", sim=sim)
    out["names"] = (DU.dump_fields(sim, st, os.path.join(d, "f")),
                    DU.dump_hydro(sim, st, "electron", os.path.join(d, "h")),
                    DU.dump_particles(sim, st, "electron",
                                      os.path.join(d, "p")))
    out["state"] = gather_to_numpy(st, sim.grid)
    # restored on the same topology: the next step as the run's own
    st2 = CKT.restore(os.path.join(d, "ck.t"), sim=sim)
    e_run = sim.energies(step(st)).double().numpy()
    e_restart = sim.energies(sim.make_step()(st2)).double().numpy()
    out["restart"] = (e_run, e_restart)
    # Poynting on (1, 2, 1) (the x-profile on (2, 1, 1) runs apart)
    out["poynting"] = _poynting((1, 2, 1), 0.75, 0.5, lambda gx: 1.0,
                                e0=1.5)
    out["poynting_x"] = _poynting((1, 2, 1), 1.0, 1.0,
                                  lambda gx: float(gx + 1))
    out["materials"] = _materials((1, 2, 1))
    out["absorber"] = _absorber((1, 2, 1))
    return out


@pytest.fixture(scope="module")
def io(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("io"))
    sim = weibel_jax.build(weibel_jax.WeibelParams(**WEIBEL,
                                                   topology=(1, 2, 1)))
    sim.use_pallas = False
    st = sim.initialize()
    CKJ.checkpt(st, os.path.join(d, "jax"), tag="0", sim=sim)
    res = launch_cpu(_two_ranks, 2, d, d, os.path.join(d, "jax.0"))
    return d, st, res


def test_checkpoint_jax_to_port(io):
    """vpic_tpu's decomposed checkpoint restores rank by rank: each rank's
    state is its brick of vpic_tpu's global state (interop's rank pick)."""
    d, st, res = io
    host = jax.device_get(st)
    for r, out in enumerate(res):
        want = state_to_numpy(state_from_numpy(host, device="cpu", rank=r))
        got = out["from_jax"]
        for n, a in got["fields"].items():
            np.testing.assert_array_equal(a, want["fields"][n])
            np.testing.assert_array_equal(a, np.asarray(
                getattr(st.fields, n))[0, r, 0])
        for k, sp in enumerate(got["species"]):
            for n, a in sp.items():
                np.testing.assert_array_equal(a, want["species"][k][n])
        assert got["step"] == want["step"] == 0


def test_checkpoint_port_to_jax(io):
    """The port's decomposed checkpoint is one file in vpic_tpu's layout:
    vpic_tpu restores it onto its (1, 2, 1) deck."""
    d, _, res = io
    sim = weibel_jax.build(weibel_jax.WeibelParams(**WEIBEL,
                                                   topology=(1, 2, 1)))
    st = CKJ.restore(os.path.join(d, "ck.t"), sim=sim)
    ref = res[0]["state"]
    assert np.asarray(st.step).shape == (1, 2, 1)
    assert int(np.asarray(st.step).max()) == STEPS
    for n, a in ref["fields"].items():
        np.testing.assert_array_equal(np.asarray(getattr(st.fields, n)), a)
    for k, sp in enumerate(ref["species"]):
        for n, a in sp.items():
            np.testing.assert_array_equal(
                np.asarray(getattr(st.species[k], n)), a)
    e_run, e_restart = res[0]["restart"]
    np.testing.assert_allclose(e_restart, e_run, rtol=0, atol=0)


def _lanes(species, g, topo):
    """(global cell, ux) of every live lane, sorted."""
    out = []
    px, py, pz = topo
    for sp in species:
        i, live, ux = (np.asarray(sp[n]) for n in ("i", "live", "ux"))
        i, live, ux = (a.reshape((px, py, pz) + a.shape[-1:])
                       for a in (i, live, ux))
        for sx in range(px):
            for sy in range(py):
                for sz in range(pz):
                    m = live[sx, sy, sz]
                    zi, r = np.divmod(i[sx, sy, sz][m].astype(np.int64),
                                      g.NX * g.NY)
                    yi, xi = np.divmod(r, g.NX)
                    cell = (xi + sx * g.nx) + 1000 * (yi + sy * g.ny) \
                        + 1000000 * (zi + sz * g.nz)
                    out.append(np.stack([cell.astype(np.float64),
                                         ux[sx, sy, sz][m]], 1))
    a = np.concatenate(out)
    return a[np.lexsort(a.T)]


def test_remap_onto_one_domain(io):
    """tests/test_io_diag.py:273: the (1, 2, 1) checkpoint remapped onto
    (1, 1, 1) holds the same lanes (global cell, momentum) and the same
    global field interiors, and the run goes on."""
    d, _, res = io
    ref = res[0]["state"]
    sim1 = _weibel((1, 1, 1))
    s1 = CKT.remap(os.path.join(d, "ck.t"), sim1)
    g2 = _weibel((1, 2, 1)).grid
    h1 = state_to_numpy(s1)
    la = _lanes(ref["species"], g2, (1, 2, 1))
    lb = _lanes([{n: a[None, None, None] for n, a in sp.items()}
                 for sp in h1["species"]], sim1.grid, (1, 1, 1))
    np.testing.assert_array_equal(la, lb)
    for n in ("ex", "ey", "cbz", "jfx"):
        a = ref["fields"][n]
        for sy in range(2):
            np.testing.assert_array_equal(
                h1["fields"][n][1:-1, 1 + sy * g2.ny:1 + (sy + 1) * g2.ny,
                                1:-1],
                a[0, sy, 0][1:-1, 1:-1, 1:-1])
    step = sim1.make_step()
    for _ in range(3):
        s1 = step(s1)
    assert torch.isfinite(sim1.energies(s1)).all()


def test_stitch_sharded_dumps(io):
    """tests/test_io_diag.py:355: the ranks' V0 field, hydro and particle
    files stitch (utilities/read_dumps.py) into the global state."""
    d, _, res = io
    ref = res[0]["state"]
    g = _weibel((1, 2, 1)).grid
    names = res[0]["names"]
    assert names == res[1]["names"] and len(names[0]) == 2
    hdr, glob = RD.stitch_fields(os.path.join(d, "f"), STEPS, (1, 2, 1))
    assert glob["ey"].shape == (g.gnz, g.gny, g.gnx)
    for sy in range(2):
        blk = glob["ey"][:, sy * g.ny:(sy + 1) * g.ny, :]
        np.testing.assert_array_equal(
            blk, ref["fields"]["ey"][0, sy, 0][1:-1, 1:-1, 1:-1])
    assert glob["nmat"].dtype == np.int16
    _, hglob = RD.stitch_hydro(os.path.join(d, "h"), STEPS, (1, 2, 1))
    assert hglob["rho"].shape == (g.gnz, g.gny, g.gnx)
    assert np.isfinite(hglob["rho"]).all()
    _, parts = RD.stitch_particles(os.path.join(d, "p"), STEPS, 2)
    k = [st.params.name for st in _weibel((1, 1, 1)).species].index(
        "electron")
    assert len(parts) == int(np.asarray(ref["species"][k]["np"]).sum())


def _poynting_x(topo):
    return _poynting(topo, 1.0, 1.0, lambda gx: float(gx + 1))


def test_poynting_on_decomposed_grids(io, tmp_path):
    """tests/test_poynting.py: the uniform wave's flux at any topology, and
    the x-profile's gated on the ix == 0 ranks equal to one domain's."""
    _, _, res = io
    cvac, A, B, e0 = 2.0, 0.75, 0.5, 1.5
    expect = A * B / (cvac * cvac * e0 * e0)
    one = _poynting_x((1, 1, 1))
    assert abs(one - 7.5 / 4.0) < 1e-6
    for r in res:
        assert abs(r["poynting"] - expect) < 1e-6 * abs(expect)
        assert abs(r["poynting_x"] - one) < 1e-6 * abs(one)
    for v in launch_cpu(_poynting_x, 2, tmp_path, (2, 1, 1)):
        assert abs(v - one) < 1e-6 * abs(one)


def test_region_materials_on_ranks_match_one_domain(io, tmp_path):
    """tests/test_materials.py:79: per-rank rasterized id meshes damp the
    wave as one domain does, on (1, 2, 1) and (2, 2, 1)."""
    _, _, res = io
    h1 = _materials((1, 1, 1))
    assert h1[-1] < 0.7 * h1[0]
    np.testing.assert_allclose(res[0]["materials"], h1, rtol=1e-5)
    for h4 in launch_cpu(_materials, 4, tmp_path, (2, 2, 1)):
        np.testing.assert_allclose(h4, h1, rtol=1e-5)


def test_interior_absorber_on_ranks_matches_one_domain(io):
    """tests/test_region_pbc.py:126: the interior absorbing box on (1, 2, 1)
    keeps what one domain keeps over 12 steps."""
    _, _, res = io
    n1 = _absorber((1, 1, 1))
    assert n1 < 2000
    assert all(r["absorber"] == n1 for r in res)
