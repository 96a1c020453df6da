"""Region-assigned materials in the port (vpic_tpu_torch/deck.py:
set_region_material, the mesh coefficients) and the shapes deck, on the
CPU against vpic_tpu from the same deck: the eight int16 stagger-class id
meshes and the 13 coefficient meshes bit for bit, the shapes deck's fields
after 10 steps to the ten-step tolerances of tests/test_pallas.py:88-94
(5e-7 + 1e-5 max|a|), its oracle (vpic_tpu/models/shapes.py:4-7), and the
fused field trio refusing mesh coefficients."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import vpic_tpu as vj
import vpic_tpu_torch as vt
from vpic_tpu.models import shapes as shapes_jax
from vpic_tpu_torch.deck import MAT_ID_ORDER
from vpic_tpu_torch.models import shapes as shapes_torch
from vpic_tpu_torch.ops import field_fuse as FF
from vpic_tpu_torch.parallel import mesh as M

from torch_parity import np_

torch.set_num_threads(2)


def _box(pkg, region_case, **kw):
    """A 12 x 10 x 6 periodic box with vacuum and one region material."""
    sim = pkg.Simulation(seed=0, **kw)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04)
    sim.define_periodic_grid((0, 0, 0), (1.2, 1.0, 0.6), (12, 10, 6))
    sim.define_material("vacuum", 1.0)
    if region_case == "aniso":
        sim.define_material("aniso", eps=(2.0, 1.5, 3.0), mu=(1.0, 3.0, 1.2),
                            sigma=(0.5, 0.0, 0.2))
        sim.define_field_array(damp=0.0)
        sim.set_region_material(
            lambda x, y, z: (x - 0.6) ** 2 + (y - 0.5) ** 2 < 0.1, "aniso")
    else:                                   # a surface material
        vol = sim.define_material("glass", eps=4.0)
        skin = sim.define_material("skin", eps=2.0, sigma=1.0)
        sim.define_field_array(damp=0.0)
        sim.set_region_material(lambda x, y, z: 0.3 < x < 0.8 and z > 0.2,
                                vol, skin)
    return sim


def _pair(case):
    if case == "shapes":
        return (shapes_jax.build(),
                shapes_torch.build(device="cpu"))
    return _box(vj, case), _box(vt, case, device="cpu")


@pytest.mark.parametrize("case", ["shapes", "aniso", "surface"])
def test_id_and_coefficient_meshes_match(case):
    sj, st = _pair(case)
    assert tuple(st._mat_ids) == MAT_ID_ORDER
    for k in MAT_ID_ORDER:
        a, b = sj._mat_ids[k], st._mat_ids[k]
        assert a.dtype == b.dtype == np.int16 and np.array_equal(a, b), k
    assert len(np.unique(st._mat_ids["ematx"])) > 1
    mj, mt = sj._material_coeffs(), st._material_coeffs()
    for f in dataclasses.fields(mt):
        a, b = np.asarray(getattr(mj, f.name)), np_(getattr(mt, f.name))
        assert b.shape == st.grid.shape, f.name
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name


def test_coefficients_built_once():
    st = _box(vt, "aniso", device="cpu")
    m = st._material_coeffs()
    state = st.initialize()
    st.energies(state)
    st.make_advance()
    assert st._material_coeffs() is m
    st.set_region_material(lambda x, y, z: x < 0.1, "vacuum")
    assert st._material_coeffs() is not m


def test_lookup_material_and_decomposed_grid():
    st = _box(vt, "surface", device="cpu")
    assert st.lookup_material("skin").id == 2
    with pytest.raises(KeyError):
        st.lookup_material("copper")
    sim = vt.Simulation(device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (4, 4, 4), (2, 1, 1))
    sim.define_material("vacuum", 1.0)
    metal = sim.define_material("metal", sigma=1.0)
    sim.define_field_array()
    # a decomposed grid paints this rank's brick: it needs the rank
    with pytest.raises(RuntimeError, match="one process per rank"):
        sim.set_region_material(vt.everywhere, "vacuum")
    with M.use(M.Mesh(1, 2, "cpu", "local")):
        sim.set_region_material(lambda x, y, z: x > 0.5, metal)
    # rank 1 holds x in [0.5, 1]: its interior is all metal
    assert (sim._mat_ids["cmat"][1:-1, 1:-1, 1:-1] == metal.id).all()


def test_shapes_fields_after_10_steps_match():
    sj, st = _pair("shapes")
    a, b = sj.initialize(), st.initialize()
    adv, step = jax.jit(sj.make_advance()), st.make_step()
    for _ in range(10):
        a, b = adv(a), step(b)
    for n in ("ex", "ey", "ez", "cbx", "cby", "cbz"):
        x = np.asarray(getattr(a.fields, n))
        assert np.abs(x - np_(getattr(b.fields, n))).max() <= \
            5e-7 + 1e-5 * np.abs(x).max(), n
    ej, et = np.asarray(sj.energies(a)), np_(st.energies(b))
    assert np.abs(ej - et).max() / ej.sum() < 1e-6


def test_shapes_oracle_conductor_dissipates():
    """While more than a quarter of the field energy on the interior cells
    lies in the conductor block the total energy does not rise from step to step, and the block
    takes more than half of the pulse's energy."""
    sim = shapes_torch.build(device="cpu")
    state = sim.initialize()
    step = sim.make_step()
    g = sim.grid
    inner = (slice(1, -1),) * 3
    inside = torch.from_numpy(sim._mat_ids["cmat"][inner] == 2)
    e0 = float(sim.energies(state).sum())
    history = []
    for _ in range(160):
        state = step(state)
        f = state.fields
        dens = sum(getattr(f, n)[inner] ** 2
                   for n in ("ex", "ey", "ez", "cbx", "cby", "cbz"))
        history.append((float(sim.energies(state).sum()),
                        float(dens[inside].sum() / dens.sum())))
    window = [e for e, share in history if share > 0.25]
    assert len(window) >= 5
    assert all(b <= a for a, b in zip(window, window[1:]))
    assert history[-1][0] < 0.5 * e0
    assert g.nx == 64 and g.ny == 16


def test_field_trio_refuses_mesh_coefficients():
    st = shapes_torch.build(device="cpu")
    m = st._material_coeffs()
    assert not FF.supports_beb(st.grid, m)
    with pytest.raises(NotImplementedError, match="mesh array"):
        FF.make_beb(st.grid, m, st.damp)
    vac = vt.Simulation(device="cpu")
    vac.define_units(1.0, 1.0)
    vac.define_timestep(0.04)
    vac.define_periodic_grid((0, 0, 0), (1, 1, 1), (4, 4, 4))
    vac.define_material("vacuum", 1.0)
    vac.define_field_array()
    assert FF.supports_beb(vac.grid, vac._material_coeffs())


# ---- tests/test_materials.py's one-device cases on the port ----

def _material_box(extra=None, region=None):
    """test_materials.py's make_sim: a 16^3 periodic box, vacuum and
    optionally one region material."""
    n = 16
    sim = vt.Simulation(seed=0, device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.5 / (n * np.sqrt(3.0)))
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, n))
    sim.define_material("vacuum", 1.0)
    m = sim.define_material(*extra[0], **extra[1]) if extra else None
    sim.define_field_array(damp=0.0)
    if extra and region is not None:
        sim.set_region_material(region, m)
    return sim


def _wave_energy(sim, steps=60):
    k = 2 * np.pi * 2
    sim.set_region_field(vt.everywhere, ey=lambda x, y, z: np.cos(k * x),
                         bz=lambda x, y, z: np.cos(k * x))
    state = sim.initialize()
    step = sim.make_step()
    e0 = float(sim.energies(state).double().sum())
    for _ in range(steps):
        state = step(state)
    return e0, float(sim.energies(state).double().sum())


def test_port_conductor_damps_wave():
    """test_materials.py::test_conductor_damps_wave: vacuum conserves the
    wave to 1e-3, a sigma = 20 slab keeps under 0.7 of it."""
    e0, e1 = _wave_energy(_material_box())
    assert abs(e1 - e0) / e0 < 1e-3
    e0, e1 = _wave_energy(_material_box(
        (("metal",), dict(eps=1.0, sigma=20.0)),
        lambda x, y, z: 0.4 < x < 0.6))
    assert e1 < 0.7 * e0


def test_port_uniform_dielectric_via_region_expansion():
    """test_materials.py::test_uniform_dielectric_via_region_expansion:
    eps = 4 everywhere through the region path (3-D coefficient meshes)
    conserves the energy to 1e-2."""
    sim = _material_box((("glass",), dict(eps=4.0)), vt.everywhere)
    m = sim._material_coeffs()
    assert m.epsx.ndim == 3 and float(m.epsx.min()) == 4.0
    e0, e1 = _wave_energy(sim, steps=40)
    assert abs(e1 - e0) / e0 < 1e-2


def test_port_anisotropic_material_coeffs():
    """test_materials.py::test_anisotropic_material_coeffs."""
    sim = _material_box((("aniso",), dict(eps=(2.0, 1.0, 1.0),
                                          mu=(1.0, 3.0, 1.0))),
                        lambda x, y, z: x > 0.5)
    m = sim._material_coeffs()
    assert m.epsx.ndim == 3
    assert float(m.epsx.max()) == 2.0 and float(m.epsx.min()) == 1.0
    assert abs(float(m.rmuy.min()) - 1.0 / 3.0) < 1e-6
    assert not torch.equal(m.epsx, m.epsy)
