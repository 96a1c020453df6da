"""The port's poynting_flux (vpic_tpu_torch/diagnostics.py;
diagnostics.cc:34-81) at topology (1, 1, 1), as tests/test_poynting.py
holds vpic_tpu's: a uniform plane wave gives S = ey cbz / (cvac^2 e0^2)
exactly, and an x-varying profile samples global x-plane 2 (ey there, cbz
averaged over planes 1 and 2), the value vpic_tpu gives."""

import numpy as np
import pytest
import torch

import vpic_tpu as vj
import vpic_tpu_torch as vt
from vpic_tpu import diagnostics as DJ
from vpic_tpu_torch import diagnostics as DT

torch.set_num_threads(2)


def _build(pkg, nx=8, ny=8, nz=4, cvac=2.0):
    sim = pkg.Simulation(seed=0, **({"device": "cpu"} if pkg is vt else {}))
    sim.define_units(cvac, 1.0)
    g0 = pkg.partition_periodic_box(0, 0, 0, 1.0, 1.0, 0.5, nx, ny, nz)
    sim.define_timestep(0.5 * g0.courant_length() / cvac)
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 0.5), (nx, ny, nz))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    return sim


def _plane_wave(state, g, amp_e, amp_b, prof=lambda gx: 1.0):
    """ey, cbz set from a y,z-uniform profile of the x index."""
    col = np.array([prof(i) for i in range(g.NX)], np.float32)
    state.fields.ey.copy_(torch.from_numpy(
        np.broadcast_to(amp_e * col, g.shape).copy()))
    state.fields.cbz.copy_(torch.from_numpy(
        np.broadcast_to(amp_b * col, g.shape).copy()))
    return state


@pytest.mark.parametrize("cvac,A,B,e0", [(2.0, 0.75, 0.5, 1.5),
                                         (1.0, -0.3, 1.25, 1.0)])
def test_poynting_uniform_wave_port(cvac, A, B, e0):
    sim = _build(vt, cvac=cvac)
    state = _plane_wave(sim.initialize(), sim.grid, A, B)
    s = float(DT.poynting_flux(state.fields, sim.grid, e0=e0))
    expect = A * B / (cvac * cvac * e0 * e0)
    assert abs(s - expect) < 1e-6 * abs(expect)


def test_poynting_samples_low_x_plane_port():
    prof = lambda gx: float(gx + 1)          # distinct value per x-plane
    sim = _build(vt)
    state = _plane_wave(sim.initialize(), sim.grid, 1.0, 1.0, prof)
    s = float(DT.poynting_flux(state.fields, sim.grid))
    # global x-plane 2: ey = 3.0, cbz averaged over planes 1, 2 = 2.5
    assert abs(s - 7.5 / 4.0) < 1e-6
    # vpic_tpu on the same fields
    sj = _build(vj)
    st = sj.initialize()
    fj = st.fields.replace(
        ey=np.asarray(state.fields.ey.numpy()),
        cbz=np.asarray(state.fields.cbz.numpy()))
    assert float(DJ.poynting_flux(fj, sj.grid)) == pytest.approx(s,
                                                                 rel=1e-6)
