"""The absorbing field faces (Higdon/Mur first-order ABC, local.c:82-107)
in the port's ops/fields, as tests/test_absorbing.py::
test_absorbing_wall_eats_pulse holds vpic_tpu's: a rightward wave packet in
a 128 x 4 x 4 box with absorbing x faces leaves under 5 % of its energy
after one transit, on the CPU; vpic_tpu's run of the same packet leaves
the same share to 1e-5 of the start energy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import vpic_tpu.grid as GJ
import vpic_tpu.ops.fields as FJ
import vpic_tpu.state as SJ
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fields as FT
import vpic_tpu_torch.state as ST

torch.set_num_threads(2)


def _grid(G):
    nx = 128
    g0 = G.partition_periodic_box(0, 0, 0, 1.0, 4 / nx, 4 / nx, nx, 4, 4)
    g0 = dataclasses.replace(g0, dt=0.5 * g0.courant_length())
    bc = list(g0.field_bc)
    bc[0] = bc[3] = G.ABSORB_FIELDS
    return dataclasses.replace(g0, field_bc=tuple(bc))


def _packet(g):
    """Ey = f(x), cBz = f(x) half a step later: a rightward gaussian."""
    xn = g.x0 + g.dx * (np.arange(g.NX) - 1.0)
    xc = xn + 0.5 * g.dx
    env = lambda x: np.exp(-0.5 * ((x - 0.5) / 0.06) ** 2) * \
        np.cos(2 * np.pi * 16 * x)
    return (np.broadcast_to(env(xn), g.shape).astype(np.float32),
            np.broadcast_to(env(xc + 0.5 * g.cvac * g.dt),
                            g.shape).astype(np.float32))


def test_absorbing_wall_eats_pulse_port():
    g = _grid(GT)
    m = ST.MaterialCoeffs(*[torch.tensor(1.0) for _ in range(13)])
    f = ST.FieldState.zeros(g, "cpu")
    ey, cbz = _packet(g)
    f.ey.copy_(torch.from_numpy(ey))
    f.cbz.copy_(torch.from_numpy(cbz))
    e0 = float(FT.energy_f(f, g, m).double().sum())
    n_steps = int(1.0 / (g.cvac * g.dt))
    for _ in range(n_steps):
        FT.advance_b(f, g, 0.5)
        FT.advance_e(f, g, m, 0.0)
        FT.advance_b(f, g, 0.5)
    e1 = float(FT.energy_f(f, g, m).double().sum())
    assert np.isfinite(e1)
    assert e1 < 0.05 * e0          # pulse absorbed, not reflected

    # vpic_tpu's run of the same packet
    gj = _grid(GJ)
    mj = SJ.MaterialCoeffs.vacuum()
    fj = SJ.FieldState.zeros(gj).replace(ey=jnp.asarray(ey),
                                         cbz=jnp.asarray(cbz))

    @jax.jit
    def run(f):
        def body(_, f):
            f = FJ.advance_b(f, gj, 0.5)
            f = FJ.advance_e(f, gj, mj, 0.0)
            return FJ.advance_b(f, gj, 0.5)
        return jax.lax.fori_loop(0, n_steps, body, f)

    e1_j = float(np.asarray(FJ.energy_f(run(fj), gj, mj), np.float64).sum())
    assert abs(e1 - e1_j) < 1e-5 * e0, (e1, e1_j, e0)
