"""Decomposed runs and their checks, one function per rank: chip_smoke.py
phases 24-28 launch them on the card through ``parallel.mesh.launch``, and
tests/test_torch_sharded*.py on the CPU at small sizes.

``run_rank(deck, params, n_steps, ...)`` builds a deck (``harris``,
``sc08``, ``reconnection`` or ``emission``, its ``topology`` in
``params``) on this rank, initializes it and runs ``n_steps``: the
energies after ``check_at`` steps (every rank sums them), the timed rest
with every kernel count set to 0 just before and read just after, particle
conservation (the ranks' live lanes and dropped lanes summed), the mesh's
traffic per step, the lanes emitted and absorbed, and, where asked, the
push kernel with this rank's remote faces against its plain version after
a migration step (after a collision firing on a deck with collision ops),
move_p walking received lanes on against its plain walk, and the
emitter's call (its aged walk through move_p) on the card against the
CPU.  On the card it times the collision stage of a firing.  It returns a
dict of plain Python values and numpy arrays.

``inject_rank(device, n_steps)`` runs the runtime-injection hook deck
(tests/test_inject_reconnection.py:12-45, with a hook that draws the same
lanes on every rank) and returns the global coordinates of the lanes this
rank holds.

The kernel checks hold PERF.md §2 row 3's WALLS tolerances: live masks,
voxels and pend codes equal but for at most 1 lane in 1e5 at a face,
offsets, momenta and remaining displacement to 3e-5, the accumulator and
rhob to 1e-5 of their largest value (float atomics).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import emission, harris, reconnection, sc08
from ..ops import field_fuse as FF
from ..ops import fused_push as FP
from ..ops import fused_push3d as FP3
from ..ops import interp as I
from ..ops import move_p as MP
from ..ops import push as P
from ..parallel import mesh as M
from . import device_averages

DECKS = dict(harris=(harris, "HarrisParams"), sc08=(sc08, "SC08Params"),
             reconnection=(reconnection, "ReconnectionParams"),
             emission=(emission, "EmissionParams"))
COUNTERS = {FP.KERNEL: FP, FP3.KERNEL: FP3, MP.KERNEL: MP, FF.KERNEL: FF}
LANE_ATOL = 3e-5
SUM_RTOL = 1e-5


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(deck: str, device, **params):
    mod, cls = DECKS[deck]
    return mod.build(getattr(mod, cls)(**params), device=device)


def total(x, g) -> torch.Tensor:
    """``x`` summed over the ranks (a float64 0-d or 1-d tensor)."""
    from ..ops.fields import all_sum
    return all_sum(torch.as_tensor(x, dtype=torch.float64), g)


def _lanes(state):
    return sum(int(sp.np) for sp in state.species)


def _counts():
    return {k: mod.launches for k, mod in COUNTERS.items()}


def _reset():
    for mod in COUNTERS.values():
        mod.launches = 0


def _host(t):
    return t.detach().cpu().numpy()


def compare_walls(fn, ref, g, species, fcoef, qms, **kw) -> dict:
    """A push kernel's WALLS instance (``fn``) against its plain version
    (``ref``) on clones of the same lanes with this rank's face codes.
    Returns the largest lane error and the lanes parked at a remote face;
    raises past the tolerances of the module docstring."""
    from ..utils.push_timing import clone_species
    outs = []
    for f in (fn, ref):
        walls = P.Walls(torch.zeros(g.nv, device=fcoef.device))
        acc = torch.zeros((g.nv, 12), device=fcoef.device)
        res = f(clone_species(species), fcoef, acc, g, qms, walls=walls,
                **kw)
        outs.append((res[0], acc, walls))
    _sync(fcoef.device)
    (sa, acc_a, wa), (sb, acc_b, wb) = outs
    err, remote = 0.0, 0
    for k, (s0, a, b) in enumerate(zip(species, sa, sb)):
        live0 = _host(s0.live)
        pa, pb = _host(wa.pends[k]), _host(wb.pends[k])
        diff = live0 & (_host(a.i != b.i) | _host(a.live != b.live)
                        | (pa != pb))
        _check(diff.sum() <= max(1, live0.sum() // 100_000),
               f"{int(diff.sum())} lanes differ in voxel, life or pend")
        for sp in (a, b):
            pos = np.stack([_host(getattr(sp, n))[diff]
                            for n in ("dx", "dy", "dz")])
            _check(not diff.any() or
                   ((1.0 - np.abs(pos)).min(axis=0) <= 1e-5).all(),
                   "a differing lane is not at a face")
        keep = live0 & ~diff
        pairs = [(_host(getattr(a, n))[keep], _host(getattr(b, n))[keep], n)
                 for n in ("dx", "dy", "dz", "ux", "uy", "uz")]
        pairs.append((_host(wa.disps[k])[:, keep],
                      _host(wb.disps[k])[:, keep], "remaining displacement"))
        for x, y, n in pairs:
            e = float(np.abs(x - y).max()) if x.size else 0.0
            _check(e <= LANE_ATOL, f"species {k}.{n}: max abs err {e}")
            err = max(err, e)
        remote += int(((pa >= 0) & (pa < P.UNFINISHED) & live0).sum())
    for x, y, n in ((acc_a, acc_b, "accumulator"), (wa.rhob, wb.rhob,
                                                    "rhob")):
        e = float((x - y).abs().max())
        scale = float(y.abs().max())
        _check(e <= SUM_RTOL * max(scale, 1e-30),
               f"{n}: max abs err {e} > {SUM_RTOL} * {scale}")
    return dict(max_abs_err=err, remote_parked=remote)


def compare_move(sp, g, qsp, seed: int = 0, n_arrivals: int = 4096) -> dict:
    """move_p walking lanes a rank received on (the migration round's
    continuation) against its plain walk: ``n_arrivals`` live lanes of
    ``sp`` are put where arrivals land, on this rank's first remote face
    (flipped offset, the face's cell), with a remaining displacement of up
    to a cell, and both walk them on from clones.  Returns the largest
    lane error and the lanes that left again."""
    from ..boundary import _remote_faces
    from ..grid import FACE_AXIS, FACE_SIDE
    dev = sp.dx.device
    bcs = P.particle_bcs(g)
    faces = [f for f in _remote_faces(g) if bcs[f] == 1]
    _check(faces, "this rank has no remote face")
    f = faces[0]
    axis, side = FACE_AXIS[f], FACE_SIDE[f]
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(_host(sp.live))[:n_arrivals]
    active = np.zeros(sp.capacity, bool)
    active[live] = True
    base = {n: _host(getattr(sp, n)).copy()
            for n in ("dx", "dy", "dz", "ux", "uy", "uz", "w", "i", "live")}
    xi, yi, zi = (_host(t) for t in P.decode_voxel(sp.i, g))
    co = [xi, yi, zi]
    co[axis] = np.where(active, 1 if side < 0 else (g.nx, g.ny, g.nz)[axis],
                        co[axis])
    base["i"] = (co[0] + g.NX * (co[1] + g.NY * co[2])).astype(np.int32)
    off = base[("dx", "dy", "dz")[axis]]
    off[active] = float(side)
    disp = rng.uniform(-1.0, 1.0, (3, sp.capacity)).astype(np.float32)
    outs = []
    for fn in (MP.move_p, MP.move_p_ref):
        s = sp.replace(**{n: torch.from_numpy(v.copy()).to(dev)
                          for n, v in base.items()})
        pend = torch.full((sp.capacity,), P.DONE, dtype=torch.int32,
                          device=dev)
        acc = torch.zeros((g.nv, 12), device=dev)
        rhob = torch.zeros(g.nv, device=dev)
        out = fn(s, pend, torch.from_numpy(disp).to(dev), acc, rhob, g, qsp,
                 torch.from_numpy(active).to(dev))
        outs.append((out[0], out[1], torch.stack(tuple(out[2])), acc))
    _sync(dev)
    (a, pa, da, acc_a), (b, pb, db, acc_b) = outs
    pa, pb = _host(pa), _host(pb)
    diff = active & ((_host(a.i) != _host(b.i)) | (pa != pb))
    _check(diff.sum() <= max(1, active.sum() // 100_000),
           f"move_p: {int(diff.sum())} lanes differ in voxel or pend")
    keep = active & ~diff
    err = 0.0
    for x, y in [(_host(getattr(a, n)), _host(getattr(b, n)))
                 for n in ("dx", "dy", "dz")] + [(_host(da), _host(db))]:
        e = float(np.abs(x[..., keep] - y[..., keep]).max())
        _check(e <= LANE_ATOL, f"move_p: max abs err {e}")
        err = max(err, e)
    e = float((acc_a - acc_b).abs().max())
    _check(e <= SUM_RTOL * max(float(acc_b.abs().max()), 1e-30),
           f"move_p: accumulator max abs err {e}")
    return dict(max_abs_err=err, walked=int(active.sum()),
                left_again=int(((pa >= 0) & (pa < P.UNFINISHED)
                                & active).sum()))


def random_lanes(g, n: int, device, seed: int = 0, n_species: int = 2):
    """``n_species`` species of ``n`` random lanes (90 % live, offsets and
    momenta to cross a face or two in a step) and a random (nv, 18)
    interpolator table on grid ``g``'s brick: a push's inputs that need no
    initialize() (so no process group).  Returns (species, fcoef, qms)."""
    from ..state import SpeciesState
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    species = []
    for _ in range(n_species):
        live = rng.random(n) < 0.9
        co = [rng.integers(1, m + 1, n) for m in (g.nx, g.ny, g.nz)]
        f32 = lambda a: a.astype(np.float32)
        species.append(SpeciesState(
            dx=t(f32(rng.uniform(-1, 1, n))), dy=t(f32(rng.uniform(-1, 1, n))),
            dz=t(f32(rng.uniform(-1, 1, n) if g.nz > 1 else np.zeros(n))),
            i=t((co[0] + g.NX * (co[1] + g.NY * co[2])).astype(np.int32)),
            ux=t(f32(rng.normal(0, 0.8, n))), uy=t(f32(rng.normal(0, 0.8, n))),
            uz=t(f32(rng.normal(0, 0.8, n))),
            w=t(f32(np.where(live, rng.uniform(0.5, 1.5, n), 0.0))),
            live=t(live), np=t(np.int32(live.sum()))))
    fcoef = t((0.05 * rng.standard_normal((g.nv, 18))).astype(np.float32))
    return species, fcoef, [(-1.0, 1.0), (1.0, 25.0)][:n_species]


def _tally(state, g) -> int:
    """The deck's absorb_tally counts, summed over its keys and the
    ranks."""
    n = sum(int(v) for k, v in state.diag.items()
            if k.startswith("absorb_tally/"))
    return int(total(n, g))


def collision_stage(sim, state):
    """The deck's collision ops firing once on ``state``'s lanes (they
    shuffle into new tensors, so the state is not changed): the species
    after them."""
    species, diag = list(state.species), dict(state.diag)
    for op in sim.collision_ops:
        if getattr(op, "has_diag", False):
            species, diag = op(species, state.fields, sim.grid, 0,
                               sim._generator, diag)
        else:
            species = op(species, state.fields, sim.grid, 0,
                         sim._generator)
    return species


def run_rank(deck: str, params: dict, n_steps: int, device="cuda",
             check_at: int = 0, compare: bool = False,
             profile_steps: int = 0, marks=()) -> dict:
    """One rank of a decomposed run (see the module docstring).  The
    returned dict: rank, transport, path, loaded (the deck's staged
    lanes), lanes (the ranks' total after initialize() and at the end),
    dropped (the ranks' total), e0 / e_check / e_end (summed energies),
    drift, marks ({k: (lanes, absorb tallies)} summed over the ranks after
    each of the first ``check_at`` steps listed in ``marks``), tally (the
    absorb tallies at the end), and over the timed steps ms_step (host
    clock around synchronize), launches (per kernel), migrated,
    staged_bytes and host_syncs (per step); on the card peak_mib (this
    rank's peak device memory over the timed steps) and, for a deck with
    collision ops, collision (launches, device ms and CUDA-event ms of one
    firing of the stage); with ``compare`` the kernel checks, with
    ``profile_steps`` the device busy share and launches of that many more
    steps under torch.profiler."""
    m = M.current()
    t0 = time.perf_counter()
    sim = build(deck, device, **params)
    g = sim.grid
    t1 = time.perf_counter()
    state = sim.initialize()
    dev = state.fields.ex.device
    _sync(dev)
    t2 = time.perf_counter()
    out = dict(rank=M.rank_of(g), transport=m.transport if m else "local",
               build_s=t1 - t0, initialize_s=t2 - t1,
               loaded=sum(st.count for st in sim.species))
    lanes0 = int(total(_lanes(state), g))
    e0 = sim.energies(state).double().cpu().numpy()
    step = sim.make_step()
    out["path"], out["fields"] = step.path, step.fields
    out["marks"] = {}
    for k in range(check_at):
        state = step(state)
        if k + 1 in marks:
            out["marks"][k + 1] = (int(total(_lanes(state), g)),
                                   _tally(state, g))
    e_check = sim.energies(state).double().cpu().numpy()
    n_timed = n_steps - check_at
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _reset()
    mig0, syncs0 = sim.migration["migrated"], sim.host_syncs
    staged0 = m.staged_bytes if m else 0
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state = step(state)
    _sync(dev)
    elapsed = time.perf_counter() - t0
    out["launches"] = _counts()
    per = max(n_timed, 1)
    out.update(
        ms_step=elapsed * 1e3 / per,
        migrated=(sim.migration["migrated"] - mig0) / per,
        host_syncs=(sim.host_syncs - syncs0) / per,
        staged_bytes=((m.staged_bytes if m else 0) - staged0) / per,
        unfinished=int(total(int(state.diag["unfinished"]), g)))
    if dev.type == "cuda":
        out["peak_mib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    e_end = sim.energies(state).double().cpu().numpy()
    out.update(e0=e0, e_check=e_check, e_end=e_end,
               drift=float(abs(e_end.sum() - e0.sum()) / e0.sum()),
               lanes=(lanes0, int(total(_lanes(state), g))),
               dropped=int(total(int(sim.migration["n_dropped"]), g)),
               tally=_tally(state, g))
    if sim.collision_ops and dev.type == "cuda":
        from . import cuda_ms, device_kernels
        stage = lambda: collision_stage(sim, state)
        kern = device_kernels(stage, 2)
        out["collision"] = dict(
            launches=sum(c for c, _ in kern.values()),
            device_ms=sum(t for _, t in kern.values()),
            ms=cuda_ms(stage, 3))
    if compare:
        qms = [(st.params.q, st.params.m) for st in sim.species]
        fcoef = I.load_interpolator(state.fields, g)
        sps = (collision_stage(sim, state) if sim.collision_ops
               else list(state.species))
        if step.path == "push2d":
            sps = [FP.bucket_sort_p(sp, g) for sp in sps]
            out["push"] = compare_walls(FP.fused_push_multi,
                                        FP.fused_push_multi_ref, g, sps,
                                        fcoef, qms)
        else:
            kw = {}
            if step.path == "push3d":
                srt = [FP3.brick_sort_p_home(sp, g) for sp in sps]
                sps, kw["homes"] = [s[0] for s in srt], [s[1] for s in srt]
            out["push"] = compare_walls(FP3.fused_push3d_multi,
                                        FP3.fused_push3d_multi_ref, g, sps,
                                        fcoef, qms, **kw)
        out["move_p"] = compare_move(state.species[0], g,
                                     sim.species[0].params.q)
        if sim.emitters and dev.type == "cuda":
            from .stochastic_checks import compare_child_langmuir
            err, new = compare_child_langmuir(sim, state, dev)
            out["emitter"] = dict(max_abs_err=err, new=new)
    if profile_steps:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        _sync(dev)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(profile_steps):
                state = step(state)
            _sync(dev)
            win_ms = (time.perf_counter() - t0) * 1e3 / profile_steps
        kern = device_averages(prof)
        dev_ms = sum(e.device_time_total for e in kern) / 1e3 / profile_steps
        out.update(profile_ms=win_ms, device_ms=dev_ms,
                   busy=dev_ms / win_ms,
                   calls=sum(e.count for e in kern) / profile_steps)
    return out


def injection_deck(device, topology=(1, 1, 1), n: int = 8, m: int = 4):
    """tests/test_inject_reconnection.py:12-45's deck (an n^3 periodic unit
    box, one species of charge -1e-6) with its hook: ``m`` aged lanes a
    step through emitter.runtime_inject, drawn from a generator seeded by
    the step, so every rank draws the same lanes (as a deck draws them
    from sync_rng) and keeps those in its brick."""
    from .. import deck as D
    from .. import emitter as E
    sim = D.Simulation(seed=0, device=device)
    sim.define_units(1.0, 1.0)
    sim.define_timestep(0.04 * 8 / n)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, n), topology)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.define_species("e", -1e-6, 1.0, max(2048, 16 * m), -1, 0, 1)

    def injector(species, f, fcoef, acc, rhob, g, step, generator):
        dev = rhob.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(1000 + int(step))
        r = lambda: torch.rand((m,), generator=gen, device=dev)
        x, y, z = r(), r(), r()
        u = 0.1 * torch.randn((3, m), generator=gen, device=dev)
        sp, acc, rhob = E.runtime_inject(
            species[0], g, acc, rhob, x, y, z, u[0], u[1], u[2],
            torch.ones(m, device=dev), -1e-6, age=r(), update_rhob=True)
        return [sp] + list(species[1:]), acc, rhob

    sim.user_particle_injection = injector
    return sim


def global_lanes(sp, g) -> np.ndarray:
    """The live lanes of ``sp`` on this rank as rows (x, y, z, ux, uy, uz,
    w) in global coordinates (float64), sorted."""
    from ..grid import flat_rank, local_corner
    live = _host(sp.live)
    xi, yi, zi = (_host(t)[live] for t in P.decode_voxel(sp.i, g))
    x0, y0, z0 = local_corner(g, flat_rank(g))
    pos = [o + (c - 1 + (_host(d)[live].astype(np.float64) + 1) * 0.5) * h
           for o, c, d, h in ((x0, xi, sp.dx, g.dx), (y0, yi, sp.dy, g.dy),
                              (z0, zi, sp.dz, g.dz))]
    rows = np.stack(pos + [_host(getattr(sp, n))[live].astype(np.float64)
                           for n in ("ux", "uy", "uz", "w")], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def inject_rank(device="cuda", n_steps: int = 10, topology=(1, 1, 1),
                n: int = 8, m: int = 4) -> dict:
    """The injection deck run ``n_steps`` (at least 1) on this rank: the
    global lanes it holds after the first step (global_lanes: the first
    hook's lanes, no push has moved them), the path, and after the run the
    ranks' total lanes and dropped lanes."""
    sim = injection_deck(device, topology, n, m)
    state = sim.initialize()
    step = sim.make_step()
    state = step(state)
    first = global_lanes(state.species[0], sim.grid)
    for _ in range(n_steps - 1):
        state = step(state)
    sp = state.species[0]
    return dict(first=first, path=step.path,
                total=int(total(int(sp.np), sim.grid)),
                dropped=int(total(int(sim.migration["n_dropped"]),
                                  sim.grid)))


def compare_injected(one, ranks, topology, n: int, dt: float,
                     atol: float = 1e-9) -> dict:
    """The lanes the ranks of ``topology`` hold after the injection deck's
    first step (``ranks``: their global_lanes) against one domain's
    (``one``), matched by momentum and weight (equal: the hook draws them
    alike and no push has moved them yet).  Positions are equal to
    ``atol`` (periodic in the unit box), but for the lanes whose aged walk
    reached a face another rank owns: the walk parks them there and drops
    the rest of the age's displacement, as vpic_tpu's does (ROADMAP Queue
    3), so each lies on a seam plane and within |u| cvac dt of the one-
    domain lane.  Returns the lanes compared and those parked."""
    key = lambda a: a[np.lexsort(a[:, 3:7].T[::-1])]
    a = key(one)
    b = key(np.concatenate(ranks))
    _check(a.shape == b.shape, f"{len(b)} lanes on the ranks, {len(a)} on "
           "one domain")
    _check(np.array_equal(a[:, 3:], b[:, 3:]), "momenta or weights differ")
    d = b[:, :3] - a[:, :3]
    d -= np.round(d)
    off = (np.abs(d) > atol).any(axis=1)
    seam = np.zeros(len(b), bool)
    for ax in range(3):
        if topology[ax] > 1:
            c = b[:, ax] * topology[ax]
            seam |= np.abs(c - np.round(c)) <= 1e-9 * n
    reach = np.linalg.norm(a[:, 3:6], axis=1) * dt
    bad = off & ~(seam & (np.linalg.norm(d, axis=1) <= reach * (1 + 1e-6)))
    _check(not bad.any(), f"{int(bad.sum())} lanes differ from one "
           f"domain's: max {np.abs(d[bad]).max() if bad.any() else 0}")
    return dict(lanes=len(b), parked=int(off.sum()))


def restart_rank(base: str, params: dict, n1: int, n2: int,
                 device="cuda") -> dict:
    """A decomposed harris run of n1 + n2 steps with a checkpoint
    ``{base}.{n1}`` after n1, and the same checkpoint restored on this
    topology and run n2 steps: both runs' summed energies at the end."""
    sim = build("harris", device, **params)
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(n1):
        state = step(state)
    from .. import checkpoint as CK
    CK.checkpt(state, base, sim=sim)
    for _ in range(n2):
        state = step(state)
    e_run = sim.energies(state).double().cpu().numpy()
    state = CK.restore(f"{base}.{n1}", sim=sim)
    step = sim.make_step()
    for _ in range(n2):
        state = step(state)
    return dict(e_run=e_run,
                e_restored=sim.energies(state).double().cpu().numpy())


def remap_run(fbase_tag: str, params: dict, n2: int, device="cuda"):
    """The checkpoint remapped onto ``params``' topology (one domain: no
    mesh needed) and run n2 steps: the energies at the end."""
    from .. import checkpoint as CK
    sim = build("harris", device, **params)
    state = CK.remap(fbase_tag, sim)
    step = sim.make_step()
    for _ in range(n2):
        state = step(state)
    return sim.energies(state).double().cpu().numpy()


def conserved(res: list, what: str) -> None:
    """Raise unless a decomposed run kept every particle: the ranks' total
    live lanes the deck's staged lanes and unchanged, and none dropped."""
    r = res[0]
    _check(r["lanes"][0] == r["loaded"],
           f"{what}: {r['loaded']} lanes staged, {r['lanes'][0]} loaded")
    _check(r["lanes"][0] == r["lanes"][1],
           f"{what}: {r['lanes'][0]} lanes became {r['lanes'][1]}")
    _check(r["dropped"] == 0, f"{what}: {r['dropped']} lanes dropped")
