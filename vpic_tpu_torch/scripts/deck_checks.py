"""The nine sample decks ported last (twostream, weibel_gold, beam_plas,
force_free, sc08, asymm4sp, dipole, waveguide, cygnus): their oracles and
a card-against-CPU check of their first steps.  chip_smoke.py phases 22-23
run these on the card at the decks' sizes below;
tests/test_torch_deck_checks.py runs them on the CPU at small sizes.

Each oracle is the assertions of the JAX package's own test of the deck
(tests/test_twostream.py, tests/test_models.py, tests/test_sample_decks.py),
applied to the port's run.  ``oracle(name, device, run, **params)`` builds
the deck (or two: the waveguide's cutoff compares two drives), advances it
only through ``run(sim, state, n) -> state`` (the caller times and counts
there), raises AssertionError naming what failed, and returns what it
measured with the last (sim, state) (and, for force_free, sc08 and
asymm4sp, the seconds of the deck's build, its host staging, and of
initialize()).

``card_vs_cpu(name, device, n_steps, **params)`` builds the deck once,
initializes it on the CPU, carries that state to ``device`` and runs
``n_steps`` on both: live masks equal, voxels equal but for at most 1 lane
in 1e5 within 1e-5 of a face, offsets and momenta to 3e-5 (PERF.md §2 row
3, tests/test_pallas.py:65-72), fields to 5e-7 + 1e-5 max|a|
(tests/test_pallas.py:88-94) and energies to 1e-5 of their sum.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..interop import state_from_numpy, state_to_numpy
from ..models import (asymm4sp, beam_plas, cygnus, dipole, force_free, sc08,
                      twostream, waveguide, weibel_gold)

DECKS = ("twostream", "weibel_gold", "beam_plas", "force_free", "sc08",
         "asymm4sp", "dipole", "waveguide", "cygnus")
MODULES = dict(twostream=(twostream, "TwoStreamParams"),
               weibel_gold=(weibel_gold, "WeibelGoldParams"),
               beam_plas=(beam_plas, "BeamPlasParams"),
               force_free=(force_free, "ForceFreeParams"),
               sc08=(sc08, "SC08Params"),
               asymm4sp=(asymm4sp, "Asymm4spParams"),
               dipole=(dipole, "DipoleParams"),
               waveguide=(waveguide, "WaveguideParams"),
               cygnus=(cygnus, "CygnusParams"))
# The sizes chip_smoke.py runs: vpic_tpu's defaults, but dipole and
# waveguide at their oracles' sizes (tests/test_sample_decks.py:18-65)
SIZES = dict(dipole=dict(n=16, L=8.0, omega=2.0),
             waveguide=dict(nx=48, ny=8, Lx=12.0, Ly=4.0))
# the reference SC08 demo's grid (SC08:40-56), one device
SC08_DEMO = dict(nx=150, ny=25, nz=100, nppc=1)
# the decks whose field advance field_beb covers (the others have absorbing
# faces or a field hook: the plain trio)
FIELD_BEB = ("twostream", "weibel_gold", "beam_plas", "force_free", "sc08",
             "asymm4sp")
LANE_ATOL = 3e-5
FIELD_RTOL, FIELD_ATOL = 1e-5, 5e-7
ENERGY_RTOL = 1e-5
FIELDS = ("ex", "ey", "ez", "cbx", "cby", "cbz", "jfx", "jfy", "jfz",
          "rhob")


def build(name, device, **params):
    """The deck at SIZES (vpic_tpu's defaults) with ``params`` over them."""
    mod, cls = MODULES[name]
    kw = dict(SIZES.get(name, {}), **params)
    return mod.build(getattr(mod, cls)(**kw), device=device)


def energies(sim, state) -> np.ndarray:
    return sim.energies(state).double().cpu().numpy()


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _drift(e0, e1):
    return abs(e1.sum() - e0.sum()) / e0.sum()


def _kept(sim, state, what):
    """Every staged particle is still live (periodic and reflecting
    boxes)."""
    got = [int(sp.np) for sp in state.species]
    live = [int(sp.live.sum()) for sp in state.species]
    want = [st.count for st in sim.species]
    _check(got == want == live, f"{what}: {want} particles became {got} "
           f"({live} live)")


def _twostream(device, run, **params):
    """tests/test_twostream.py: 2 steps, then 58 more."""
    sim = build("twostream", device, **params)
    state = sim.initialize()
    e0 = energies(sim, state)
    state = run(sim, state, 2)
    e_early = energies(sim, state)
    state = run(sim, state, 58)
    e1 = energies(sim, state)
    _check(np.isfinite(e1).all(), "twostream: non-finite energies")
    drift = _drift(e0, e1)
    _check(drift < 1e-2, f"twostream: total energy drift {drift}")
    _check(e1[0] > 8 * max(e_early[0], 1e-12) and e1[0] > 2e-3,
           f"twostream: ex energy {e1[0]} (at step 2: {e_early[0]})")
    _check(e1[1] + e1[2] < 0.1 * e1[0],
           f"twostream: transverse {e1[1] + e1[2]} against ex {e1[0]}")
    _kept(sim, state, "twostream")
    return dict(steps=60, drift=drift, growth=e1[0] / e_early[0],
                sim=sim, state=state)


def _conserves(name, n_steps, bound, keeps):
    """A run of n_steps with the total energy drift below ``bound``
    (tests/test_sample_decks.py's force_free and sc08, test_models.py's
    asymm4sp); ``keeps``: every particle kept (sc08)."""
    def oracle(device, run, **params):
        t0 = time.perf_counter()
        sim = build(name, device, **params)
        t1 = time.perf_counter()
        state = sim.initialize()
        if sim.device.type == "cuda":
            torch.cuda.synchronize(sim.device)
        t2 = time.perf_counter()
        e0 = energies(sim, state)
        if name == "asymm4sp":
            bz = state.fields.cbz
            _check(float(bz.min()) < -0.5 * abs(float(bz.max())),
                   "asymm4sp: the layer is not asymmetric")
            _check(len(sim.species) == 4, "asymm4sp: not 4 species")
        state = run(sim, state, n_steps)
        e1 = energies(sim, state)
        _check(np.isfinite(e1).all(), f"{name}: non-finite energies")
        drift = _drift(e0, e1)
        _check(drift < bound, f"{name}: total energy drift {drift}")
        if keeps:
            _kept(sim, state, name)
        return dict(steps=n_steps, drift=drift, build_s=t1 - t0,
                    initialize_s=t2 - t1, sim=sim, state=state)
    return oracle


def _beam_plas(device, run, **params):
    """tests/test_models.py::test_beam_plasma_two_stream: 150 steps, drift
    < 5e-3, ex energy grown 20 times."""
    sim = build("beam_plas", device, **params)
    state = sim.initialize()
    e0 = energies(sim, state)
    state = run(sim, state, 150)
    e1 = energies(sim, state)
    drift = _drift(e0, e1)
    _check(drift < 5e-3, f"beam_plas: total energy drift {drift}")
    _check(e1[0] > 20 * max(e0[0], 1e-12),
           f"beam_plas: ex energy {e1[0]} from {e0[0]}")
    _kept(sim, state, "beam_plas")
    return dict(steps=150, drift=drift, ex_energy=e1[0], sim=sim,
                state=state)


def _weibel_gold(device, run, **params):
    """weibel_gold's oracle is the reference's energies_gold, which the
    repo does not hold (tests/test_weibel_gold_parity.py skips without it):
    here 200 of its 700 steps with every particle kept, finite energies and
    the drift guard of PERF.md §2 row 2 (< 1e-3)."""
    sim = build("weibel_gold", device, **params)
    state = sim.initialize()
    e0 = energies(sim, state)
    state = run(sim, state, 200)
    e1 = energies(sim, state)
    _check(np.isfinite(e1).all(), "weibel_gold: non-finite energies")
    drift = _drift(e0, e1)
    _check(drift < 1e-3, f"weibel_gold: total energy drift {drift}")
    _kept(sim, state, "weibel_gold")
    return dict(steps=200, drift=drift, sim=sim, state=state)


def _dipole(device, run, **params):
    """tests/test_sample_decks.py::test_dipole_radiates_into_absorbers:
    120 steps radiate, 120 more stay bounded by the absorbers."""
    sim = build("dipole", device, **params)
    state = run(sim, sim.initialize(), 120)
    e = energies(sim, state)
    _check(np.isfinite(e).all(), "dipole: non-finite energies")
    fe = e[:6].sum()
    _check(fe > 0.0, "dipole: nothing radiated")
    state = run(sim, state, 120)
    fe2 = energies(sim, state)[:6].sum()
    _check(fe2 < 4.0 * fe, f"dipole: field energy {fe2} after {fe}")
    return dict(steps=240, field_energy=(fe, fe2), sim=sim, state=state)


def _demod_far(sim, run, n_settle, periods=3):
    """test_sample_decks.py's synchronous demodulation of ez at the far end
    at the drive frequency (the probes stay on the device until the end)."""
    state = run(sim, sim.initialize(), n_settle)
    om, dt = sim.meta["omega"], sim.meta["dt"]
    n_demod = max(int(periods * 2 * np.pi / (om * dt)), 8)
    ny = state.fields.ez.shape[1] - 2
    probes = []
    for _ in range(n_demod):
        state = run(sim, state, 1)
        probes.append(state.fields.ez[1, ny // 2 + 1, 42].clone())
    t = dt * np.arange(n_settle + 1, n_settle + n_demod + 1)
    acc = np.sum(torch.stack(probes).double().cpu().numpy()
                 * np.exp(-1j * om * t))
    return 2.0 * abs(acc) / n_demod, n_settle + n_demod, state


def _waveguide(device, run, **params):
    """tests/test_sample_decks.py::test_waveguide_cutoff: TE1 above cutoff
    (omega 1.6) reaches the far end, below it (0.3, a 6-period ramp) it is
    evanescent; ~4 transits then 3 periods of demodulation each."""
    kw = dict(SIZES["waveguide"], **params)
    hi = waveguide.build(waveguide.WaveguideParams(**dict(kw, omega=1.6)),
                         device=device)
    n = int(4.0 * kw["Lx"] / hi.meta["dt"])
    amp_hi, steps_hi, _ = _demod_far(hi, run, n)
    lo = waveguide.build(waveguide.WaveguideParams(
        **dict(kw, omega=0.3, ramp_periods=6.0)), device=device)
    amp_lo, steps_lo, state = _demod_far(lo, run, n)
    _check(amp_hi > 10 * max(amp_lo, 1e-12) and amp_hi > 0.02,
           f"waveguide: far-end amplitude {amp_hi} above cutoff, {amp_lo} "
           "below")
    return dict(steps=steps_hi + steps_lo, amplitudes=(amp_hi, amp_lo),
                sim=lo, state=state)


def _cygnus(device, run, **params):
    """tests/test_sample_decks.py::test_cygnus_pulse_drives_fields: 20
    steps; the feed-gap pulse puts ex within [0.1, 100] x V_gap."""
    sim = build("cygnus", device, **params)
    state = run(sim, sim.initialize(), 20)
    e = energies(sim, state)
    _check(np.isfinite(e).all() and e[:6].sum() > 0,
           f"cygnus: field energies {e[:6]}")
    p = cygnus.CygnusParams()
    v_gap = p.V_peak / (p.r_o - p.r_i)
    ex = float(state.fields.ex.abs().max())
    _check(0.1 * v_gap < ex < 100 * v_gap,
           f"cygnus: max |ex| {ex} against V_gap {v_gap}")
    return dict(steps=20, ex_over_v_gap=ex / v_gap, sim=sim, state=state)


ORACLES = dict(twostream=_twostream, weibel_gold=_weibel_gold,
               beam_plas=_beam_plas,
               force_free=_conserves("force_free", 20, 5e-3, False),
               sc08=_conserves("sc08", 15, 5e-3, True),
               asymm4sp=_conserves("asymm4sp", 20, 5e-3, False),
               dipole=_dipole, waveguide=_waveguide, cygnus=_cygnus)


def plain_run(sim, state, n):
    """run() without counting: n steps of the deck's step."""
    step = sim.make_step()
    for _ in range(n):
        state = step(state)
    return state


def oracle(name, device, run=plain_run, **params) -> dict:
    return ORACLES[name](device, run, **params)


def sc08_demo(device, run=plain_run, n_steps=50, **params) -> dict:
    """sc08 at the reference demo's 150 x 25 x 100 x 1 ppc on one device:
    n_steps with every particle kept and drift < 5e-3 (the sc08 oracle's
    bounds, tests/test_sample_decks.py:158-170)."""
    return _conserves("sc08", n_steps, 5e-3, True)(
        device, run, **dict(SC08_DEMO, **params))


def _lane_errors(a, b, what):
    """Live masks equal, voxels equal but for at most 1 lane in 1e5 within
    1e-5 of a face; returns the largest offset / momentum error of the
    others."""
    la, lb = a.live.cpu().numpy(), b.live.cpu().numpy()
    _check(np.array_equal(la, lb), f"{what}: live masks differ")
    diff = la & (a.i.cpu().numpy() != b.i.cpu().numpy())
    _check(diff.sum() <= max(1, la.sum() // 100_000),
           f"{what}: {int(diff.sum())} voxels differ")
    for sp in (a, b):
        pos = np.stack([getattr(sp, n).cpu().numpy()[diff]
                        for n in ("dx", "dy", "dz")])
        _check(not diff.any() or (1.0 - np.abs(pos)).min(axis=0).max()
               <= 1e-5, f"{what}: a differing voxel is not at a face")
    keep = la & ~diff
    err = 0.0
    for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
        x = getattr(a, n).cpu().numpy()[keep]
        y = getattr(b, n).cpu().numpy()[keep]
        e = float(np.abs(x - y).max()) if x.size else 0.0
        _check(e <= LANE_ATOL, f"{what}.{n}: max abs err {e}")
        err = max(err, e)
    return err


def card_vs_cpu(name, device, n_steps=5, **params) -> dict:
    """n_steps from one initial state (initialize() on the CPU) on
    ``device`` and on the CPU; returns the largest lane, field (relative to
    its largest value) and energy (relative to their sum) differences."""
    sim = build(name, "cpu", **params)
    s_cpu = sim.initialize()
    s_dev = state_from_numpy(state_to_numpy(s_cpu), device=device)
    s_cpu = plain_run(sim, s_cpu, n_steps)
    sim.device = torch.device(device)
    s_dev = plain_run(sim, s_dev, n_steps)
    e_dev = energies(sim, s_dev)
    sim.device = torch.device("cpu")
    e_cpu = energies(sim, s_cpu)
    lane = 0.0
    for k, (a, b) in enumerate(zip(s_dev.species, s_cpu.species)):
        lane = max(lane, _lane_errors(a, b, f"{name} species {k}"))
    field = 0.0
    for n in FIELDS:
        x = getattr(s_cpu.fields, n).double()
        y = getattr(s_dev.fields, n).double().cpu()
        err = float((x - y).abs().max())
        scale = float(x.abs().max())
        _check(err <= FIELD_ATOL + FIELD_RTOL * scale,
               f"{name}: {n} max abs err {err} (max |{n}| {scale})")
        field = max(field, err / max(scale, 1e-30))
    energy = float(np.abs(e_dev - e_cpu).max() / max(e_cpu.sum(), 1e-30))
    _check(energy <= ENERGY_RTOL,
           f"{name}: energies {e_dev} on the device, {e_cpu} on the CPU")
    return dict(lane=lane, field=field, energy=energy, steps=n_steps)
