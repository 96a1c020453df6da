"""Decomposed runs and their checks, one function per rank: chip_smoke.py
phases 24-27 launch them on the card through ``parallel.mesh.launch``, and
tests/test_torch_sharded*.py on the CPU at small sizes.

``run_rank(deck, params, n_steps, ...)`` builds a deck (``harris`` or
``sc08``, its ``topology`` in ``params``) on this rank, initializes it and
runs ``n_steps``: the energies after ``check_at`` steps (every rank sums
them), the timed rest with every kernel count set to 0 just before and read
just after, particle conservation (the ranks' live lanes and dropped lanes
summed), the mesh's traffic per step, and, where asked, the push kernel
with this rank's remote faces against its plain version after a migration
step, and move_p walking received lanes on against its plain walk.  It
returns a dict of plain Python values and numpy arrays.

The kernel checks hold PERF.md §2 row 3's WALLS tolerances: live masks,
voxels and pend codes equal but for at most 1 lane in 1e5 at a face,
offsets, momenta and remaining displacement to 3e-5, the accumulator and
rhob to 1e-5 of their largest value (float atomics).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models import harris, sc08
from ..ops import field_fuse as FF
from ..ops import fused_push as FP
from ..ops import fused_push3d as FP3
from ..ops import interp as I
from ..ops import move_p as MP
from ..ops import push as P
from ..parallel import mesh as M

DECKS = dict(harris=(harris, "HarrisParams"), sc08=(sc08, "SC08Params"))
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


def run_rank(deck: str, params: dict, n_steps: int, device="cuda",
             check_at: int = 0, compare: bool = False,
             profile_steps: int = 0) -> dict:
    """One rank of a decomposed run (see the module docstring).  The
    returned dict: rank, transport, path, lanes (the ranks' total before
    and after), dropped (the ranks' total), e0 / e_check / e_end (summed
    energies), drift, and over the timed steps ms_step (host clock around
    synchronize), launches (per kernel), migrated, staged_bytes and
    host_syncs (per step); with ``compare`` the kernel checks, with
    ``profile_steps`` the device busy share and launches of that many
    more steps under torch.profiler."""
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
               build_s=t1 - t0, initialize_s=t2 - t1)
    lanes0 = int(total(_lanes(state), g))
    e0 = sim.energies(state).double().cpu().numpy()
    step = sim.make_step()
    out["path"], out["fields"] = step.path, step.fields
    for _ in range(check_at):
        state = step(state)
    e_check = sim.energies(state).double().cpu().numpy()
    n_timed = n_steps - check_at
    _sync(dev)
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
    e_end = sim.energies(state).double().cpu().numpy()
    out.update(e0=e0, e_check=e_check, e_end=e_end,
               drift=float(abs(e_end.sum() - e0.sum()) / e0.sum()),
               lanes=(lanes0, int(total(_lanes(state), g))),
               dropped=int(total(int(sim.migration["n_dropped"]), g)))
    if compare:
        qms = [(st.params.q, st.params.m) for st in sim.species]
        fcoef = I.load_interpolator(state.fields, g)
        if step.path == "push2d":
            sps = [FP.bucket_sort_p(sp, g) for sp in state.species]
            out["push"] = compare_walls(FP.fused_push_multi,
                                        FP.fused_push_multi_ref, g, sps,
                                        fcoef, qms)
        else:
            kw = {}
            sps = list(state.species)
            if step.path == "push3d":
                srt = [FP3.brick_sort_p_home(sp, g) for sp in sps]
                sps, kw["homes"] = [s[0] for s in srt], [s[1] for s in srt]
            out["push"] = compare_walls(FP3.fused_push3d_multi,
                                        FP3.fused_push3d_multi_ref, g, sps,
                                        fcoef, qms, **kw)
        out["move_p"] = compare_move(state.species[0], g,
                                     sim.species[0].params.q)
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
        kern = [e for e in prof.key_averages()
                if e.device_type.name == "CUDA" and e.device_time_total > 0]
        dev_ms = sum(e.device_time_total for e in kern) / 1e3 / profile_steps
        out.update(profile_ms=win_ms, device_ms=dev_ms,
                   busy=dev_ms / win_ms,
                   calls=sum(e.count for e in kern) / profile_steps)
    return out


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
    live lanes unchanged and none dropped."""
    r = res[0]
    _check(r["lanes"][0] == r["lanes"][1],
           f"{what}: {r['lanes'][0]} lanes became {r['lanes'][1]}")
    _check(r["dropped"] == 0, f"{what}: {r['dropped']} lanes dropped")
