"""The port's lpi deck (vpic_tpu_torch/models/lpi.py) at a small size on the
CPU, where its 2-D kernel path runs its plain versions: absorbing field
walls, the laser through user_field_injection, damp = 0.001, and at the x
walls either absorbing particle faces (set after build(), deterministic:
held to vpic_tpu's general path, use_pallas=False) or the deck's
maxwellian_reflux (torch's randoms: held to conservation).

Tolerances: fields and rhob to 5e-7 + 1e-5 max|a| and energies to 1e-6 of
their sum after 10 steps (tests/test_pallas.py:88-94); live counts
equal."""

import jax
import numpy as np
import torch

import vpic_tpu.models.lpi as lpi_jax
import vpic_tpu_torch.models.lpi as lpi_torch
from vpic_tpu.grid import ABSORB_PARTICLES as ABSORB_J
from vpic_tpu_torch.grid import ABSORB_PARTICLES as ABSORB_T
from vpic_tpu_torch.ops.push import CUSTOM_BASE

from torch_parity import np_

torch.set_num_threads(2)

# 32 x 8 cells, a hot slab from x = 4 to the +x wall: lanes reach the walls
SMALL = dict(nx=32, ny=8, nppc=4, Lx=8.0, Ly=2.0, slab_x0=4.0, uth_e=0.2,
             laser_a0=0.5)


def _run_port(sim, n_steps):
    s = sim.initialize()
    step = sim.make_step()
    assert step.path == "push2d"
    for _ in range(n_steps):
        s = step(s)
    return s


def test_lpi_absorbing_walls_match_jax():
    sj = lpi_jax.build(lpi_jax.LPIParams(**SMALL))
    st = lpi_torch.build(lpi_torch.LPIParams(**SMALL), device="cpu")
    for sim, absorb in ((sj, ABSORB_J), (st, ABSORB_T)):
        sim.set_domain_particle_bc(0, absorb)
        sim.set_domain_particle_bc(3, absorb)
        # no face parks a lane now: the reflux handlers would find nothing
        # (dropped, so vpic_tpu compiles a step without boundary_p)
        sim.pbc_handlers = {}
    sj.use_pallas = False
    a = sj.initialize()
    n0 = [int(np.asarray(sp.np)) for sp in a.species]
    adv = jax.jit(sj.make_advance())
    for _ in range(10):
        a = adv(a)
    b = _run_port(st, 10)
    live_a = [int(np.asarray(sp.live).sum()) for sp in a.species]
    live_b = [int(np_(sp.live).sum()) for sp in b.species]
    assert live_a == live_b and live_b[0] < n0[0], (live_a, live_b, n0)
    for n in ("ex", "ey", "ez", "jfx", "jfy", "cbz", "rhob"):
        x = np.asarray(getattr(a.fields, n))
        y = np_(getattr(b.fields, n))
        assert np.abs(x - y).max() < 5e-7 + 1e-5 * np.abs(x).max(), n
    # the laser drove the antenna plane in both
    assert np.abs(np_(b.fields.ey)[:, :, 1]).max() > 0
    e_a = np.asarray(sj._energies_local(a.fields, a.species), np.float64)
    e_b = st.energies(b).double().numpy()
    assert np.abs(e_a - e_b).max() / e_a.sum() < 1e-6


def test_lpi_reflux_conserves_particles():
    """maxwellian_reflux at both x walls: every lane parked at a wall is
    re-emitted, so both species keep every particle, and the state stays
    finite."""
    st = lpi_torch.build(lpi_torch.LPIParams(**SMALL), device="cpu")
    parked = []

    def spy_on(h):
        def spy(gen, sp, pend, disp, acc, rhob, g, spp, key, diag):
            parked.append(int((pend == CUSTOM_BASE + key).sum()))
            return h(gen, sp, pend, disp, acc, rhob, g, spp, key, diag)
        spy.in_place = True
        return spy

    st.pbc_handlers = {k: spy_on(h) for k, h in st.pbc_handlers.items()}
    s0 = st.initialize()
    n0 = [int(sp.np) for sp in s0.species]
    s = _run_port(st, 20)
    assert sum(parked) > 10
    assert [int(sp.np) for sp in s.species] == n0
    assert [int(sp.live.sum()) for sp in s.species] == n0
    assert torch.isfinite(st.energies(s)).all()
    for sp in s.species:
        assert torch.isfinite(sp.ux[sp.live]).all()
        assert (sp.dx[sp.live].abs() <= 1).all()
