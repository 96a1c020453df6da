"""The port's field decks (vpic_tpu_torch/models/dipole.py, waveguide.py,
cygnus.py: absorbing field faces and a current or field injection hook,
so the step's field advance is the plain trio) against vpic_tpu's on the
CPU:

(a) each deck built by both packages is the same build (grid, dt, face
    codes, materials with their region id meshes, region particle faces;
    tests/torch_parity.assert_same_build);
(b) 10 steps agree with vpic_tpu's general path (use_pallas=False): fields
    to 5e-7 + 1e-5 max|a|, energies to 1e-6 of their sum
    (tests/test_pallas.py:88-94);
(c) the oracles of tests/test_sample_decks.py on the port, at their
    sizes (through vpic_tpu_torch/scripts/deck_checks.py, as chip_smoke.py
    runs them on the card): the dipole's radiation bounded by the
    absorbers, the waveguide's cutoff, cygnus' pulse driving ex to within
    [0.1, 100] x V_gap."""

import numpy as np
import pytest
import torch

import vpic_tpu.models.cygnus as cygnus_jax
import vpic_tpu.models.dipole as dipole_jax
import vpic_tpu.models.waveguide as waveguide_jax
from vpic_tpu_torch.models import cygnus, dipole, waveguide
from vpic_tpu_torch.scripts import deck_checks as DC

from torch_parity import assert_same_build, np_, run_deck_pair

torch.set_num_threads(2)

# name -> (vpic_tpu module, port module, params class, params, the port's
# path, steps held to the ten-step tolerances)
SMALL = {
    "dipole": (dipole_jax, dipole, "DipoleParams", dict(n=8, L=4.0),
               "general", 10),
    "waveguide": (waveguide_jax, waveguide, "WaveguideParams",
                  dict(nx=24, ny=8, Lx=6.0, Ly=4.0, omega=1.6), "push2d",
                  10),
    # 7 steps: the feed-gap hook's float32 pulse is within 2 ulps of
    # vpic_tpu's (XLA folds dt * V_peak / t_rise into one constant), and
    # the y spacing of 1e-6 m against dx ~ 4e-3 m amplifies that ulp in
    # the small components (ez, cbx) past 1e-5 of their largest from step
    # 8 (ROADMAP Queue 3, "cygnus' hook rounding")
    "cygnus": (cygnus_jax, cygnus, "CygnusParams", dict(nx=48, nz=12),
               "general", 7),
}
WHY = {"dipole": ["face 0 is absorbing"],
       "waveguide": ["user_field_injection", "face 3 is absorbing"],
       "cygnus": ["user_field_injection", "face 2 is absorbing"]}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_field_deck_build_and_steps_match(name):
    mj, mt, cls, kw, path, n_steps = SMALL[name]
    sj = mj.build(getattr(mj, cls)(**kw))
    st = mt.build(getattr(mt, cls)(**kw), device="cpu")
    assert_same_build(sj, st)
    a, b, _, _ = run_deck_pair(sj, st, n_steps, path=path)
    # the hook drove the fields in both
    assert np.abs(np_(b.fields.ex) if name == "cygnus"
                  else np_(b.fields.ez)).max() > 0
    label = st.make_step().fields
    assert label.startswith("plain: ")
    for why in WHY[name]:
        assert why in label, (why, label)


def test_cygnus_hook_within_two_ulps():
    """The port's feed-gap pulse against vpic_tpu's compiled hook, over the
    rise, hold and fall: within two float32 ulps of it (one rounding of
    the pulse, one of the field per volt)."""
    import jax
    import jax.numpy as jnp
    from vpic_tpu.state import FieldState as FieldJ
    from vpic_tpu_torch.state import FieldState as FieldT
    kw = dict(nx=48, nz=12)
    sj = cygnus_jax.build(cygnus_jax.CygnusParams(**kw))
    st = cygnus.build(cygnus.CygnusParams(**kw), device="cpu")
    hook = jax.jit(sj.user_field_injection)
    dt = st.grid.dt
    p = cygnus.CygnusParams()
    t_end = p.t_rise + p.t_hold + p.t_fall
    for step in list(range(0, 40, 3)) + [int(t_end / dt) + k
                                         for k in (-30, -2, 0, 2)]:
        a = np.asarray(hook(FieldJ.zeros(sj.grid), jnp.int32(step)).ex)
        b = st.user_field_injection(FieldT.zeros(st.grid, "cpu"),
                                    step).ex.numpy()
        assert np.all(np.abs(a - b) <= 2 * np.spacing(np.abs(a))), step


def test_cygnus_vocabulary():
    """size_domain, set_domain_geometry and the y self-joins give cygnus'
    grid: x from 0 with a symmetric face, periodic y, absorbing z faces,
    reflecting particle faces but in y, and five absorbing conductor
    surfaces."""
    from vpic_tpu_torch.grid import ABSORB_FIELDS, SYMMETRIC
    sim = cygnus.build(device="cpu")
    g = sim.grid
    p = cygnus.CygnusParams()
    assert (g.nx, g.ny, g.nz) == (190, 1, 18)
    assert g.x0 == 0.0 and g.dx == pytest.approx(p.r_o / p.nx)
    assert g.dy == pytest.approx(1e-6)
    assert g.field_bc == (SYMMETRIC, 0, ABSORB_FIELDS, -1, 0, ABSORB_FIELDS)
    assert g.particle_bc == (-1, 0, -1, -1, 0, -1)
    assert sim._vbc is not None and (sim._vbc == -2).any()
    assert len(sim.materials) == 3 and sim._multi_material
    assert sim._path()[0] == "general"


def test_dipole_oracle():
    """test_sample_decks.py::test_dipole_radiates_into_absorbers: no
    species, 120 steps radiate, 120 more stay bounded."""
    r = DC.oracle("dipole", "cpu")
    assert r["sim"].species == [] and r["steps"] == 240
    assert r["sim"].energies(r["state"]).shape == (6,)


def test_waveguide_oracle():
    """test_sample_decks.py::test_waveguide_cutoff: TE1 above cutoff
    reaches the far end; below cutoff it is evanescent."""
    amp_hi, amp_lo = DC.oracle("waveguide", "cpu")["amplitudes"]
    assert amp_hi > 10 * amp_lo


def test_cygnus_oracle():
    """test_sample_decks.py::test_cygnus_pulse_drives_fields."""
    r = DC.oracle("cygnus", "cpu", nx=64, nz=12, t_end=2e-9)
    assert 0.1 < r["ex_over_v_gap"] < 100
