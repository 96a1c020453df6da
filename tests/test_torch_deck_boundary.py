"""The port's deck with particle boundaries against vpic_tpu on the CPU:
custom handlers on domain faces through the general-path step (3-D grids
the brick path does not take: the 3-D push without home maps, whose plain
version is advance_p per species, then boundary_p with its handler runs
after the migration rounds, vpic_tpu/deck.py:1446-1496), the
choice of path from the deck, the injection hooks, the handlers' diag keys
made at initialize and carried across by interop, and utils/profile.

The decks are tests/test_boundary_emission.py's (an 8^3 box, a beam at
x = 0.9 running into an absorbing-field, custom-particle +x wall).
Deterministic cases are held to vpic_tpu's general path (use_pallas=False):
live masks, tallies and link records equal, fields and rhob to 5e-7 +
1e-5 max|a|; reflux (torch's randoms) to conservation."""

import json

import jax
import numpy as np
import pytest
import torch

import vpic_tpu as vj
import vpic_tpu_torch as vt
from vpic_tpu import boundary_ops as BOJ
from vpic_tpu_torch import boundary_ops as BOT
from vpic_tpu_torch import step_graph
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.utils import profile

from torch_parity import np_

torch.set_num_threads(2)


def base_sim(pkg, handler, nx=8, n_inj=30, q=1e-6):
    """test_boundary_emission.py's base_sim and beam, in either package."""
    kw = {"device": "cpu"} if pkg is vt else {}
    sim = pkg.Simulation(seed=0, **kw)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (nx, nx, nx))
    sim.set_domain_field_bc(pkg.BOUNDARY(1, 0, 0), pkg.ABSORB_FIELDS)
    sim.set_domain_particle_bc(pkg.BOUNDARY(1, 0, 0), handler)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    spc = sim.define_species("beam", q, 1.0, 512, -1, 0, 1)
    v = 0.4
    u = v / np.sqrt(1 - v * v)
    for k in range(n_inj):
        sim.inject_particle(spc, 0.9, (k % 7 + 0.5) / 8, (k % 5 + 0.5) / 8,
                            u, 0, 0, 1.0)
    if pkg is vj:
        sim.use_pallas = False
    return sim


def run_both(sj, st, n_steps=12):
    a = sj.initialize()
    adv = jax.jit(sj.make_advance())
    for _ in range(n_steps):
        a = adv(a)
    b = st.initialize()
    step = st.make_step()
    assert step.path == "general"
    for _ in range(n_steps):
        b = step(b)
    for n in ("ex", "ey", "jfx", "cbz", "rhob"):
        x = np.asarray(getattr(a.fields, n))
        assert np.abs(x - np_(getattr(b.fields, n))).max() < \
            5e-7 + 1e-5 * np.abs(x).max(), n
    np.testing.assert_array_equal(np.asarray(a.species[0].live),
                                  np_(b.species[0].live))
    return a, b


def test_absorb_tally_general_path_matches_jax():
    sj = base_sim(vj, BOJ.absorb_tally())
    st = base_sim(vt, BOT.absorb_tally())
    a, b = run_both(sj, st)
    face = next(iter(st.pbc_handlers))
    assert int(b.species[0].np) == 0
    assert BOT.tally_of(b.diag, "beam", face) == 30 == \
        BOJ.tally_of(a.diag, "beam", face)
    assert float(b.fields.rhob.sum()) > 0.5 * 30 * 1e-6 / st.grid.dV


def test_link_boundary_general_path_matches_jax(tmp_path):
    lj = BOJ.link_boundary(prefix=str(tmp_path / "j"), buffer_size=128)
    lt = BOT.link_boundary(prefix=str(tmp_path / "t"), buffer_size=128)
    a, b = run_both(base_sim(vj, lj, n_inj=20), base_sim(vt, lt, n_inj=20))
    lj.write_links(jax.device_get(a.diag), rank=0)
    diag = lt.write_links(b.diag, rank=0)
    lines_t = open(f"{tmp_path / 't'}.0").read().splitlines()
    lines_j = open(f"{tmp_path / 'j'}.0").read().splitlines()
    assert len(lines_t) == len(lines_j) == 20
    # the same records (in the order of the lanes' slots, which may differ
    # where two lanes hit the wall in one step): species, key and voxel
    # equal, the particle's offsets, momenta and weight to atol 3e-5
    recs = [sorted((ln.split()[:3], [float(v) for v in ln.split()[3:]])
                   for ln in lines) for lines in (lines_t, lines_j)]
    for (ht, vt_), (hj, vj_) in zip(*recs):
        assert ht == hj
        np.testing.assert_allclose(vt_, vj_, atol=3e-5)
    assert all(int(v) == 0 for k, v in diag.items() if k.endswith("/n"))


def test_maxwellian_reflux_general_path_conserves():
    """test_boundary_emission.py:28-49 through the port's general path."""
    mr = BOT.maxwellian_reflux({"beam": 0.15}, {"beam": 0.05})
    sim = base_sim(vt, mr, n_inj=50, q=1e-20)
    state = sim.initialize()
    step = sim.make_step()
    assert step.path == "general"
    for _ in range(12):   # enough steps to hit the +x wall
        state = step(state)
    sp = state.species[0]
    assert int(sp.np) == 50          # refluxed, not absorbed
    ux = np_(sp.ux)[np_(sp.live)]
    assert (ux < 0).any()            # some particles now travel backwards
    # refluxed momenta follow the new thermal scales, not the beam
    assert np.abs(ux[ux < 0]).max() < 1.0


def test_reflux_randoms_follow_the_seed():
    """The handlers draw from the Simulation's generator, seeded from its
    seed at initialize(): the same seed gives the same run."""
    outs = []
    for seed in (0, 0, 1):
        mr = BOT.maxwellian_reflux({"beam": 0.15}, {"beam": 0.05})
        sim = base_sim(vt, mr, n_inj=50, q=1e-20)
        sim.seed = seed
        state = sim.initialize()
        step = sim.make_step()
        for _ in range(12):
            state = step(state)
        outs.append(np_(state.species[0].ux).copy())
    assert np.array_equal(outs[0], outs[1])
    assert not np.array_equal(outs[0], outs[2])


def test_path_is_chosen_from_the_deck():
    """2-D decks with walls take the 2-D kernel, 3-D brick grids the 3-D
    kernel (residency with headroom), other 3-D grids the general path (the
    3-D kernel without home maps); a handler that is not in place and
    remote faces raise."""
    def sim_of(shape, handler=None, cap=512):
        sim = vt.Simulation(device="cpu")
        sim.define_units(1.0, 1.0)
        sim.define_timestep(0.01)
        sim.define_periodic_grid((0, 0, 0), (1, 1, 1), shape)
        if handler is not None:
            sim.set_domain_particle_bc(0, handler)
            sim.set_domain_particle_bc(3, vt.ABSORB_PARTICLES)
        sim.define_material("vacuum", 1.0)
        sim.define_field_array()
        sim.define_species("e", -1.0, 1.0, cap)
        return sim

    assert sim_of((16, 8, 1), BOT.absorb_tally())._path()[0] == "push2d"
    assert sim_of((16, 16, 16), BOT.absorb_tally())._path()[0] == "push3d"
    assert sim_of((16, 16, 16), BOT.absorb_tally(),
                  cap=40_000)._residency_mode()[0]
    assert sim_of((8, 8, 8))._path()[0] == "general"

    def not_in_place(*args):
        return args[1:7]
    with pytest.raises(NotImplementedError, match="not in place"):
        sim_of((16, 8, 1), not_in_place).make_advance()
    sim = sim_of((16, 8, 1))
    sim.set_domain_particle_bc(1, vt.grid.P_REMOTE)
    sim.set_domain_particle_bc(4, vt.grid.P_REMOTE)
    with pytest.raises(NotImplementedError, match="remote"):
        sim.make_advance()


def test_injection_hooks_run_where_the_step_runs_them():
    """user_current_injection after the accumulator unload, before
    advance_b; user_field_injection after advance_e, before the second
    half advance_b (vpic_tpu/deck.py:1489-1496); both get the step."""
    sim = base_sim(vt, BOT.absorb_tally())
    seen = []

    def current(f, step):
        seen.append(("current", step, float(f.jfx.abs().sum()) > 0))
        f.jfy[:, :, :] += 1e-3
        return f

    def field(f, step):
        seen.append(("field", step))
        f.ez[:, 2, :] = 0.25
        return f

    sim.user_current_injection = current
    sim.user_field_injection = field
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(2):
        state = step(state)
    assert seen == [("current", 0, True), ("field", 0),
                    ("current", 1, True), ("field", 1)]
    assert (np_(state.fields.ez)[:, 2, 1:-1] == 0.25).all()


def test_handler_diag_is_fixed_at_initialize_and_carried(tmp_path):
    """The handlers' diag keys exist from initialize() on and the step
    never adds one; interop carries them to numpy and back."""
    lt = BOT.link_boundary(prefix=str(tmp_path / "t"), buffer_size=16)
    sim = base_sim(vt, lt)
    state = sim.initialize()
    keys = set(state.diag)
    assert {k for k in keys if k.startswith("link/")} == {
        f"link/{tmp_path / 't'}/beam/f3/{leaf}"
        for leaf in ("n", "buf", "vox")}
    step = sim.make_step()
    for _ in range(12):
        state = step(state)
    assert set(state.diag) == keys
    back = state_from_numpy(state_to_numpy(state), device="cpu")
    for k in keys:
        assert np.array_equal(np_(back.diag[k]), np_(state.diag[k])), k
    assert int(back.diag[f"link/{tmp_path / 't'}/beam/f3/n"]) == 30


def test_profile_timers_and_trace(tmp_path):
    prof = profile.Profile()
    for _ in range(3):
        with prof.tic("step"):
            torch.ones(4).sum()
    table = prof.update_profile(dump=False)
    assert "step" in table.splitlines()[1] and table.split()[-1] == "3"
    with profile.trace(str(tmp_path)) as p:
        torch.ones(64).cumsum(0)
    assert len(p.key_averages()) > 0
    doc = json.load(open(tmp_path / "trace.json"))
    assert "traceEvents" in doc
    # no graph replayed: no stage track
    assert not [e for e in doc["traceEvents"]
                if e.get("tid") == profile.STAGE_TID]

    # the stage track: a replay's map over the device records the trace
    # holds (two kernels added to the CPU trace as the card would write
    # them), logged as a profiled replay logs it
    stage_map = (profile.Run("advance_p", "k", ((0, "fused_push2d_kernel"),)),
                 profile.Run("field_advance", "k", ((0, "field_beb"),)))
    kernels = [{"ph": "X", "cat": "kernel", "name": n, "pid": 0, "tid": 7,
                "ts": t, "dur": 5.0}
               for n, t in (("fused_push2d_kernel(Push2dArgs)", 1.0),
                            ("field_beb_grid_kernel(BebArgs)", 8.0))]
    with profile.trace(str(tmp_path)) as p:
        real = p.export_chrome_trace

        def export(path):
            real(path)
            with open(path) as fh:
                d = json.load(fh)
            d["traceEvents"].extend(kernels)
            with open(path, "w") as fh:
                json.dump(d, fh)

        p.export_chrome_trace = export
        step_graph.replay_log.add(stage_map)
        torch.ones(64).cumsum(0)
    track = [e for e in json.load(open(tmp_path / "trace.json"))[
        "traceEvents"] if e.get("tid") == profile.STAGE_TID
        and e["ph"] == "X"]
    assert [(e["name"], e["ts"], e["dur"]) for e in track] == [
        ("advance_p", 1.0, 5.0), ("field_advance", 8.0, 5.0)]
    step_graph.replay_log.clear()
