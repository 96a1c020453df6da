"""The port's 3-D step against vpic_tpu, on the CPU: a 16^3 harris deck
for 10 steps against vpic_tpu's general path, and the outbox-overflow deck
of tests/test_residency.py:66-101.  Also: the entry points default to the
card, the residency step reads the device once per step and no more, its
rebucket copies into the state's storage, the step goes through both
kernel wrappers, and the per-step-sort path agrees with the residency
path.

Tolerances: live counts and voxel multisets equal; the harris fields
5e-7 + 1e-5 max|a| and energies 1e-6 of their sum (test_pallas.py:88-94);
energies of the two 3-D paths 2e-5 of the largest (test_residency.py:39)."""

import jax
import numpy as np
import pytest
import torch

import vpic_tpu as vj
import vpic_tpu_torch as vt
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.residency as RES
from vpic_tpu.models import harris as harris_jax
from vpic_tpu_torch.models import harris

from torch_parity import (assert_close_rel, build3d_pair, build_pair, np_,
                          to_torch)

torch.set_num_threads(2)


def test_entry_points_default_to_the_card():
    p = harris.HarrisParams(nx=16, ny=16, nz=16, nppc=1, Lx=8.0, Ly=8.0,
                            Lz=8.0)
    assert harris.build(p).device.type == "cuda"
    assert vt.Simulation().device.type == "cuda"
    sim = harris.build(p, device="cpu")
    assert sim.device.type == "cpu"
    assert vt.Simulation(device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            harris.build(p).initialize()


HARRIS3D = dict(nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0,
                headroom=6.0)


def test_harris3d_matches_general_path():
    """16^3 x 4 ppc harris with headroom for residency's 4 slack blocks per
    brick, 10 steps, against vpic_tpu's general path (use_pallas=False).
    Both states' energies are taken by the port's float32 energies, which
    match a float64 sum here: vpic_tpu's own float32 field sum is 1.9e-5
    off it on this deck, which would spend the whole budget."""
    sj = harris_jax.build(harris_jax.HarrisParams(**HARRIS3D))
    sj.use_pallas = False
    st = harris.build(harris.HarrisParams(**HARRIS3D), device="cpu")
    assert st._residency_mode() == (True, 4)
    s_j = sj.initialize()
    adv = jax.jit(sj.make_advance())
    s_t = st.initialize()
    energies = lambda s: st.energies(s).double().numpy()
    e0_j = energies(to_torch(s_j))
    assert np.abs(e0_j - energies(s_t)).max() / e0_j.sum() < 1e-6
    step = st.make_step()
    for _ in range(10):
        s_j = adv(s_j)
        s_t = step(s_t)
    for n in ("jfx", "jfy", "jfz", "ex", "ey", "cbz"):
        assert_close_rel(getattr(s_j.fields, n), getattr(s_t.fields, n),
                         1e-5, 5e-7, n)
    e_j = energies(to_torch(s_j))
    assert np.abs(e_j - energies(s_t)).max() / e_j.sum() < 1e-6
    for a, b in zip(s_j.species, s_t.species):
        la, lb = np.asarray(a.live), np_(b.live)
        assert la.sum() == lb.sum() == int(b.np)
        assert np.array_equal(np.sort(np.asarray(a.i)[la]),
                              np.sort(np_(b.i)[lb]))
    assert int(s_t.diag["unfinished"]) == 0


def _beam_deck(pkg, **kw):
    """test_residency.py:66-88: 1024 particles in ONE cell at a brick edge
    all streaming +x, so every lane leaves its brick in the same step and
    overflows the 128-column outbox."""
    sim = pkg.Simulation(seed=5, **kw)
    sim.define_units(1.0, 1.0)
    n = 16
    g0 = pkg.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, n)
    sim.define_timestep(0.6 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, n))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    el = sim.define_species("e", -1.0, 1.0, 24000, -1, 4, 1)
    rng = np.random.default_rng(0)
    for _ in range(1024):
        sim.inject_particle(el, 7.9 / 16, rng.uniform(0.01, 0.99),
                            rng.uniform(0.01, 0.99), 50.0, 0.0, 0.0, 1.0)
    return sim


def test_outbox_overflow_rebuckets_and_conserves():
    st = _beam_deck(vt, device="cpu")
    assert st._residency_mode()[0]
    s = st.initialize()
    step = st.make_step()
    for _ in range(3):
        s = step(s)
        assert int(s.species[0].live.sum()) == 1024
    assert int(s.diag["_res_rebuckets"]) >= 1
    sj = _beam_deck(vj)
    sj.use_pallas = False
    s_j = sj.initialize()
    adv = jax.jit(sj.make_advance())
    for _ in range(3):
        s_j = adv(s_j)
    lj, lt = np.asarray(s_j.species[0].live), np_(s.species[0].live)
    assert np.array_equal(np.sort(np.asarray(s_j.species[0].i)[lj]),
                          np.sort(np_(s.species[0].i)[lt]))


def test_outbox_overflow_rebucket_copies_into_the_state():
    """The rebucket path writes its sort into the state's extent slices:
    every lane tensor keeps its storage, and every particle, its weight and
    the live count (np) are kept through the rebuckets."""
    st = _beam_deck(vt, device="cpu")
    s = st.initialize()
    sp0 = s.species[0]
    ptrs = [getattr(sp0, n).data_ptr() for n in FP3.LANE_FIELDS]
    w0 = float(sp0.w[sp0.live].double().sum())
    step = st.make_step()
    for _ in range(3):
        s = step(s)
        sp = s.species[0]
        assert [getattr(sp, n).data_ptr() for n in FP3.LANE_FIELDS] == ptrs
        assert int(sp.np) == int(sp.live.sum()) == 1024
        assert float(sp.w[sp.live].double().sum()) == w0
        assert bool((sp.i[sp.live] > 0).all())
    assert int(s.diag["_res_rebuckets"]) >= 1


def test_residency_step_reads_the_device_once(monkeypatch):
    """The rebucket-or-merge decision is the residency step's one host
    read (Tensor.__bool__); item / nonzero / numpy / tolist never run, and
    Simulation.host_syncs counts the reads."""
    _, st = build3d_pair()
    s = st.initialize()
    step = st.make_step()
    reads = []
    real_bool = torch.Tensor.__bool__

    def forbid(name):
        def f(*a, **kw):
            raise AssertionError(f"step called Tensor.{name}")
        return f

    def counted(t):
        reads.append(1)
        return real_bool(t)

    for name in ("item", "nonzero", "numpy", "tolist", "__int__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, forbid(name))
    monkeypatch.setattr(torch.Tensor, "__bool__", counted)
    for _ in range(5):
        s = step(s)
    monkeypatch.undo()
    assert len(reads) == 5 and st.host_syncs == 5


def test_step_goes_through_both_kernel_wrappers(monkeypatch):
    calls = {"push": [], "merge": []}
    push, merge = FP3.fused_push3d_multi, RES.merge_p

    def spy_push(species, *a, **kw):
        calls["push"].append(kw.get("residency"))
        return push(species, *a, **kw)

    def spy_merge(*a, **kw):
        calls["merge"].append(1)
        return merge(*a, **kw)

    monkeypatch.setattr(FP3, "fused_push3d_multi", spy_push)
    monkeypatch.setattr(RES, "merge_p", spy_merge)
    _, st = build3d_pair()
    s = st.initialize()
    step = st.make_step()
    for _ in range(4):
        s = step(s)
    assert calls["push"] == [True] * 4
    assert len(calls["merge"]) == 4 - int(s.diag["_res_rebuckets"])


def _old_plan(sps, emits, obx, ores, homes, spid, usable, g, inb=RES.INB):
    """The residency step's plan as the step made it before plan existed:
    its own calls of the three plain functions and the rebuild bool."""
    free_j = RES.block_counts(sps, emits)
    homes_cat = torch.cat(homes) if len(homes) > 1 else homes[0]
    compact, starts_j, a_j, overflow, stats = RES.plan_exchange(
        obx, homes_cat, spid, usable, free_j, g, inb)
    misplaced = RES.any_misplaced(sps, emits, homes, g)
    return RES.Plan(compact, starts_j, a_j,
                    overflow | (ores > 0) | misplaced, stats, overflow,
                    misplaced)


@pytest.mark.parametrize("deck", ["harris", "beam"])
def test_residency_step_plans_through_the_wrapper(monkeypatch, deck):
    """The eager CPU residency step plans with residency.plan once a step
    and gives the lanes, rebuckets and np of a step that calls the plain
    functions itself, bit for bit (the beam deck rebuckets)."""
    calls = []
    plan = RES.plan

    def spy(*a, **kw):
        calls.append(1)
        return plan(*a, **kw)

    runs = []
    for fn in (spy, _old_plan):
        monkeypatch.setattr(RES, "plan", fn)
        st = (build3d_pair()[1] if deck == "harris"
              else _beam_deck(vt, device="cpu"))
        s = st.initialize()
        step = st.make_step()
        for _ in range(4):
            s = step(s)
        runs.append(s)
    assert len(calls) == 4
    a, b = runs
    assert int(a.diag["_res_rebuckets"]) == int(b.diag["_res_rebuckets"])
    if deck == "beam":
        assert int(a.diag["_res_rebuckets"]) >= 1
    for x, y in zip(a.species, b.species):
        for n in FP3.LANE_FIELDS + ("np",):
            assert torch.equal(getattr(x, n), getattr(y, n)), n


def test_per_step_sort_path_matches_residency():
    """Capacity without room for a slack block: the brick sort every step
    and the push without outboxes; the same particles as the residency
    path."""
    outs = []
    for capacity in (6144, 24000):
        _, st = build3d_pair(capacity=capacity)
        s = st.initialize()
        assert ("_res_valid" in s.diag) == (capacity == 24000)
        step = st.make_step()
        for _ in range(4):
            s = step(s)
        live = np_(s.species[0].live)
        outs.append((st.energies(s).double().numpy(), int(live.sum()),
                     np.sort(np_(s.species[0].i)[live])))
    (e0, n0, i0), (e1, n1, i1) = outs
    assert n0 == n1 == 5000
    assert np.array_equal(i0, i1)
    assert np.abs(e0 - e1).max() / np.abs(e0).max() < 2e-5


def test_residency_knob_and_refused_decks():
    """Residency is chosen as vpic_tpu's pallas_residency="auto" chooses
    it, from the capacity headroom; 2-D decks never take it."""
    for capacity in (24000, 6144):
        sj, st = build3d_pair(capacity=capacity)
        assert st._residency_mode() == sj._residency_mode()
    assert st._residency_mode() == (False, 0)
    sj, st = build_pair()
    assert st._residency_mode() == sj._residency_mode() == (False, 0)
    # 3-D grids the brick path does not take run the general path (no
    # residency), as the JAX package runs them off the TPU
    sim = vt.Simulation(device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.01)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (12, 16, 16))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array()
    assert sim._residency_mode() == (False, 0)
    with pytest.raises(NotImplementedError, match="general push path"):
        FP3.check3d(sim.grid)
    step = sim.make_step()
    assert step.path == "general"
    assert step(sim.initialize()).step == 1
