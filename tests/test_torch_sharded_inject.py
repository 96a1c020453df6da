"""Runtime injection on a decomposed grid (vpic_tpu_torch/emitter.py
runtime_inject, the user_particle_injection hook) against vpic_tpu and
against one domain, on the CPU.

vpic_tpu's runtime_inject converts against the global grid but builds the
voxel with the shard's own NX, NY: under shard_map every shard inserts
every lane, most of them in the wrong cell (the first test shows it; ROADMAP
Queue 3).  The port's keeps on each rank the lanes whose global cell lies
in its brick, as VPIC's inject_particle (misc.cc:16-100) injects only
into the local domain: the ranks' lanes, in global coordinates, equal one
domain's to 1e-9 (float64 reconstruction of exact float32 offsets).  An
aged lane whose walk reaches a face another rank owns parks on it, as
vpic_tpu's walk parks it (sharded_checks.compare_injected).  Then the
hook of tests/test_inject_reconnection.py:12-45 on 2 Gloo ranks, and the
decomposed step's order: the hook before boundary_p's migration rounds
(vpic_tpu/deck.py:1420-1440)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu as vj
import vpic_tpu.emitter as EJ
import vpic_tpu.state as SJ
import vpic_tpu_torch as vt
import vpic_tpu_torch.emitter as ET
import vpic_tpu_torch.state as ST
from vpic_tpu_torch.parallel import mesh as M
from vpic_tpu_torch.scripts import sharded_checks as SC
from torch_parity import jax_sharded, launch_cpu

torch.set_num_threads(2)

TOPO = (2, 1, 1)
CAP, N_LANES, DT = 512, 96, 0.05
POS_ATOL = 1e-9


def _grid(pkg, topology=TOPO, **kw):
    sim = pkg.Simulation(**kw)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(DT)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (8, 8, 4), topology)
    return sim.grid


def _lanes(seed=6):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(x=f32(rng.uniform(0, 1, N_LANES)),
                y=f32(rng.uniform(0, 1, N_LANES)),
                z=f32(rng.uniform(0, 1, N_LANES)),
                ux=f32(rng.normal(0, 0.5, N_LANES)),
                uy=f32(rng.normal(0, 0.5, N_LANES)),
                uz=f32(rng.normal(0, 0.5, N_LANES)),
                w=f32(rng.uniform(0.5, 2, N_LANES)),
                age=f32(rng.uniform(0, 1, N_LANES)))


def _empty(cap):
    cols = {n: np.zeros(cap, np.float32) for n in ("dx", "dy", "dz", "ux",
                                                   "uy", "uz", "w")}
    return dict(cols, i=np.zeros(cap, np.int32), live=np.zeros(cap, bool),
                np=np.int32(0))


def test_jax_runtime_inject_inserts_every_lane_on_every_shard():
    """What vpic_tpu does: each shard inserts all N_LANES lanes, and on
    every shard most of them decode to another global position than the
    one injected."""
    g = _grid(vj)
    lanes = _lanes()
    tile = lambda a: np.broadcast_to(a, TOPO + a.shape).copy()
    sp = SJ.SpeciesState(**{k: jnp.asarray(tile(np.asarray(v)))
                            for k, v in _empty(CAP).items()})
    args = (sp,) + tuple(jnp.asarray(tile(lanes[k]))
                         for k in ("x", "y", "z", "ux", "uy", "uz", "w"))

    def local(a):
        s, x, y, z, ux, uy, uz, w = a
        return EJ.runtime_inject(s, g, jnp.zeros((g.nv, 12)),
                                 jnp.zeros((g.nv,)), None, x, y, z, ux, uy,
                                 uz, w, -1.0)[0]

    out = jax_sharded(local, g, args)
    assert (np.asarray(out.np) == N_LANES).all()
    gt = _grid(vt, device="cpu")
    for r in range(2):
        idx = vt.grid.rank_coords(gt, r)
        s = ST.SpeciesState(**{k: torch.from_numpy(np.array(
            np.asarray(getattr(out, k))[idx])) for k in ST.SPECIES_NAMES})
        with M.use(M.Mesh(r, 2, "cpu", "local")):
            got = SC.global_lanes(s, gt)
        want = np.stack([lanes[k].astype(np.float64) for k in
                         ("x", "y", "z", "ux", "uy", "uz", "w")], axis=1)
        key = lambda a: a[np.lexsort(a[:, 3:7].T[::-1])]
        moved = np.abs(key(got)[:, :3] - key(want)[:, :3]).max(axis=1)
        assert (moved > 1e-3).sum() > N_LANES // 4


def _port_rank(r, lanes, aged):
    """runtime_inject on rank r of TOPO (one domain for r None): this
    rank's lanes in global coordinates, np and the live count."""
    if r is None:
        g, mesh = _grid(vt, (1, 1, 1), device="cpu"), None
    else:
        g, mesh = _grid(vt, device="cpu"), M.Mesh(r, 2, "cpu", "local")
    sp = ST.SpeciesState(**{k: torch.from_numpy(np.array(v))
                            for k, v in _empty(CAP).items()})
    t = {k: torch.from_numpy(v.copy()) for k, v in lanes.items()}
    with M.use(mesh):
        out, acc, rhob = ET.runtime_inject(
            sp, g, torch.zeros((g.nv, 12)), torch.zeros(g.nv), t["x"],
            t["y"], t["z"], t["ux"], t["uy"], t["uz"], t["w"], -1.0,
            age=t["age"] if aged else None, update_rhob=True)
        return SC.global_lanes(out, g), int(out.np), int(out.live.sum())


@pytest.mark.parametrize("aged", [False, True])
def test_runtime_inject_keeps_each_ranks_lanes(aged):
    """The ranks' lanes together are the one-domain call's: positions to
    POS_ATOL (aged lanes parked at a seam within their age's reach),
    momenta and weights equal; each rank's np counts its own."""
    lanes = _lanes()
    lanes["w"][::7] = -1.0                      # skipped lanes
    one, n1, _ = _port_rank(None, lanes, aged)
    got, n_ranks = [], 0
    for r in range(2):
        rows, n, live = _port_rank(r, lanes, aged)
        assert n == live == len(rows)
        got.append(rows)
        n_ranks += n
    assert n_ranks == n1 == int((lanes["w"] >= 0).sum())
    res = SC.compare_injected(one, got, TOPO, 8, DT, POS_ATOL)
    assert res["lanes"] == n1
    if not aged:
        assert res["parked"] == 0


def test_injection_hook_on_ranks_matches_one_domain(tmp_path):
    """The hook of tests/test_inject_reconnection.py:12-45 (aged lanes, a
    generator seeded by the step so every rank draws the same) on (2, 1,
    1): after the first step the ranks' lanes are one domain's
    (compare_injected); after 10 steps every lane is kept."""
    one = SC.inject_rank("cpu", 10, m=32)
    res = launch_cpu(SC.inject_rank, 2, tmp_path, "cpu", 10, TOPO, 8, 32)
    cmp = SC.compare_injected(one["first"], [r["first"] for r in res], TOPO,
                              8, 0.04, POS_ATOL)
    assert cmp["lanes"] == 32
    assert res[0]["total"] == one["total"] == 10 * 32
    assert res[0]["dropped"] == 0 and res[0]["path"] == "general"


def _order(shape):
    """The step's path and its order of the injection hook and boundary_p
    on this rank of an absorb_tally deck decomposed (2, 1, 1)."""
    from vpic_tpu_torch import boundary_ops as BO
    from vpic_tpu_torch import deck as D
    sim = vt.Simulation(seed=0, device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), shape, (2, 1, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.define_species("e", -1e-6, 1.0, 2048, -1, 0, 1)
    sim.set_domain_particle_bc(vt.BOUNDARY(1, 0, 0), BO.absorb_tally())
    seen = []
    real = D.B.boundary_p

    def boundary_p(*a, **kw):
        seen.append("boundary_p")
        return real(*a, **kw)

    def injector(species, f, fcoef, acc, rhob, g, step, generator):
        seen.append("inject")
        return species, acc, rhob

    D.B.boundary_p = boundary_p
    try:
        sim.user_particle_injection = injector
        state = sim.initialize()
        step = sim.make_step()
        step(state)
    finally:
        D.B.boundary_p = real
    return step.path, seen


def _orders():
    return [_order((16, 8, 1)), _order((32, 16, 16))]


def test_decomposed_step_injects_before_boundary_p(tmp_path):
    """On both kernel paths of a decomposed grid the hook runs before
    boundary_p (on one domain after it: tests/test_torch_emission.py)."""
    for res in launch_cpu(_orders, 2, tmp_path):
        assert res == [("push2d", ["inject", "boundary_p"]),
                       ("push3d", ["inject", "boundary_p"])]
