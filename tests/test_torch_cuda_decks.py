"""The hand kernels on the nine sample decks' path, on the card, against
their plain PyTorch versions.  Every test here is marked ``gpu`` and skips
without a CUDA device (decided inside the fixture, never at import).  This
file imports neither jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_decks.py

- the 2-D push kernel on twostream's 64 x 1 x 1 state (one-cell periodic y
  and z axes), after the bucket sort and after 30 steps;
- field_beb's step instance against beb_ref bit for bit on one-cell y and z
  axes, (64, 1, 1) and (16, 1, 1), periodic and with pec x faces, and on
  the twostream and weibel_gold decks' own fields;
- the 3-D push kernel without home maps (the general path) on a scaled
  sc08, 30 x 5 x 20 (pec field and reflecting particle x faces; the 8^3
  bricks do not tile it), after the general path's sort and after 5 steps;
- one step of each field deck (dipole, waveguide, cygnus: the plain trio
  with their hooks) on the card against the CPU, and no field_beb launch.

Tolerances: offsets and momenta to 3e-5 (test_pallas.py:68), voxels equal
but for at most 1 lane in 1e5 within 1e-5 of a face, the accumulator to
1e-5 max|acc| (tests/test_torch_cuda.py); field_beb bit for bit; the field
decks' fields to 5e-7 + 1e-5 max|a| (test_pallas.py:88-94)."""

import dataclasses

import numpy as np
import pytest
import torch

import vpic_tpu_torch.grid as G
import vpic_tpu_torch.ops.field_fuse as FF
import vpic_tpu_torch.ops.fused_push as FP
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.interp as I
import vpic_tpu_torch.ops.push as P
import vpic_tpu_torch.state as ST
from vpic_tpu_torch.models import (cygnus, dipole, sc08, twostream,
                                   waveguide, weibel_gold)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _clone_sp(species):
    return [sp.replace(**{n: getattr(sp, n).clone()
                          for n in ST.SPECIES_NAMES}) for sp in species]


def _compare(sk, acc_k, sr, acc_r):
    for a, b in zip(sk, sr):
        live = a.live.cpu().numpy()
        assert np.array_equal(live, b.live.cpu().numpy())
        diff = a.i.cpu().numpy()[live] != b.i.cpu().numpy()[live]
        assert diff.sum() <= max(1, live.sum() // 100_000)
        for sp in (a, b):
            pos = np.stack([getattr(sp, n).cpu().numpy()[live][diff]
                            for n in ("dx", "dy", "dz")])
            if diff.any():
                assert ((1.0 - np.abs(pos)).min(axis=0) <= 1e-5).all()
        for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
            np.testing.assert_allclose(
                getattr(a, n).cpu().numpy()[live][~diff],
                getattr(b, n).cpu().numpy()[live][~diff], atol=3e-5,
                err_msg=n)
    da, db = acc_k.cpu().numpy(), acc_r.cpu().numpy()
    assert np.abs(da - db).max() <= 1e-5 * max(np.abs(db).max(), 1e-3)


def _qms(sim):
    return [(st.params.q, st.params.m) for st in sim.species]


def test_push2d_on_twostream(cuda):
    """64 x 1 x 1: a lane's y and z neighbours are its own voxel's row."""
    sim = twostream.build(device=cuda)
    state = sim.initialize()
    g = sim.grid
    assert (g.nx, g.ny, g.nz) == (64, 1, 1)
    step = sim.make_step()
    assert step.path == "push2d" and step.fields == "field_beb"
    for k in range(2):
        if k:
            for _ in range(30):
                state = step(state)
        species = [FP.bucket_sort_p(sp, g, extent=st.count)
                   for sp, st in zip(state.species, sim.species)]
        fcoef = I.load_interpolator(state.fields, g)
        zeros = lambda: torch.zeros((g.nv, 12), device=cuda)
        n0 = FP.launches
        sk, acc_k, unf_k = FP.fused_push_multi(_clone_sp(species), fcoef,
                                               zeros(), g, _qms(sim))
        sr, acc_r, unf_r = FP.fused_push_multi_ref(_clone_sp(species), fcoef,
                                                   zeros(), g, _qms(sim))
        torch.cuda.synchronize()
        assert FP.launches == n0 + 1
        assert int(unf_k) == int(unf_r) == 0
        _compare(sk, acc_k, sr, acc_r)


def _random_fields(n, faces, device, seed):
    g = G.partition_periodic_box(0, 0, 0, 1.0, 0.05, 0.05, *n, dt=0.01,
                                 cvac=1.0, eps0=1.0)
    for face, bc in enumerate(faces):
        g = g.with_bc(face, fbc=bc)
    rng = np.random.default_rng(seed)
    f = ST.FieldState(**{k: torch.as_tensor(
        rng.standard_normal(g.shape).astype(np.float32), device=device)
        for k in ST.FIELD_NAMES})
    m = ST.MaterialCoeffs(**{k: torch.tensor(v, device=device) for k, v in
                             dict(decayx=0.91, decayy=0.93, decayz=0.95,
                                  drivex=0.97, drivey=0.96, drivez=0.94,
                                  rmux=0.8, rmuy=0.85, rmuz=0.9,
                                  nonconductive=1.0, epsx=1.2, epsy=1.1,
                                  epsz=1.3).items()})
    return g, f, m


def _clone_f(f):
    return dataclasses.replace(
        f, **{n: getattr(f, n).clone() for n in ST.FIELD_NAMES})


def _beb_bit_for_bit(g, f, m, damp):
    fk, fr = _clone_f(f), _clone_f(f)
    n0 = FF.launches
    FF.make_beb(g, m, damp)(fk)
    FF.beb_ref(fr, g, m, damp)
    torch.cuda.synchronize()
    assert FF.launches == n0 + 1
    for k in ST.FIELD_NAMES:
        a, b = getattr(fk, k), getattr(fr, k)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k


@pytest.mark.parametrize("pec_x", [False, True])
@pytest.mark.parametrize("nx", [64, 16])
def test_field_beb_one_cell_axes(cuda, nx, pec_x):
    """The ghost rows of a one-cell axis are one row from their source."""
    Y, Pc = G.PERIODIC, G.PEC
    faces = (Pc, Y, Y, Pc, Y, Y) if pec_x else (Y,) * 6
    g, f, m = _random_fields((nx, 1, 1), faces, cuda, seed=nx)
    assert FF.refusal(g, m) is None
    _beb_bit_for_bit(g, f, m, 0.01)


@pytest.mark.parametrize("deck", ["twostream", "weibel_gold"])
def test_field_beb_on_one_cell_decks(cuda, deck):
    if deck == "twostream":
        sim = twostream.build(twostream.TwoStreamParams(nppc=8), device=cuda)
    else:
        sim = weibel_gold.build(weibel_gold.WeibelGoldParams(nppc=20),
                                device=cuda)
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(5):
        state = step(state)
    assert step.fields == "field_beb"
    _beb_bit_for_bit(sim.grid, state.fields, sim._material_coeffs(),
                     sim.damp)


def test_push3d_general_path_on_scaled_sc08(cuda):
    """30 x 5 x 20 sc08: pec / reflecting x faces, no bricks; the general
    path's sort, then the 3-D kernel without home maps against advance_p
    per species, from the initial state and after 5 steps."""
    sim = sc08.build(sc08.SC08Params(nx=30, ny=5, nz=20, nppc=2),
                     device=cuda)
    state = sim.initialize()
    g = sim.grid
    step = sim.make_step()
    assert step.path == "general" and not FP3.supports3d(g)
    assert not P.has_walls(g, None)
    for k in range(2):
        if k:
            n0 = FP3.launches
            for _ in range(5):
                state = step(state)
            assert FP3.launches == n0 + 5
        species = [P.sort_p(sp) for sp in state.species]
        fcoef = I.load_interpolator(state.fields, g)
        zeros = lambda: torch.zeros((g.nv, 12), device=cuda)
        ker = FP3.fused_push3d_multi(_clone_sp(species), fcoef, zeros(), g,
                                     _qms(sim))
        ref = FP3.fused_push3d_multi_ref(_clone_sp(species), fcoef, zeros(),
                                         g, _qms(sim))
        torch.cuda.synchronize()
        assert int(ker[5]) == int(ref[5]) == 0
        _compare(ker[0], ker[1], ref[0], ref[1])


FIELD_DECKS = {
    "dipole": lambda dev: dipole.build(dipole.DipoleParams(n=16, L=8.0),
                                       device=dev),
    "waveguide": lambda dev: waveguide.build(waveguide.WaveguideParams(
        nx=48, ny=8, Lx=12.0, Ly=4.0, omega=1.6), device=dev),
    "cygnus": lambda dev: cygnus.build(device=dev),
}


@pytest.mark.parametrize("deck", sorted(FIELD_DECKS))
def test_field_deck_step_card_vs_cpu(cuda, deck):
    states, launches = [], 0
    for dev in (cuda, "cpu"):
        sim = FIELD_DECKS[deck](dev)
        state = sim.initialize()
        step = sim.make_step()
        assert step.fields.startswith("plain: ")
        n0 = FF.launches
        for _ in range(3):
            state = step(state)
        launches += FF.launches - n0
        states.append(state)
    assert launches == 0
    for n in ("ex", "ey", "ez", "cbx", "cby", "cbz", "jfz"):
        a = getattr(states[1].fields, n).double()
        b = getattr(states[0].fields, n).double().cpu()
        err = float((a - b).abs().max())
        assert err <= 5e-7 + 1e-5 * float(a.abs().max()), (n, err)
