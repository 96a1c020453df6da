"""The stochastic operators on a device against the CPU, from the same
draws: the draws are made on the CPU by each op's ``draw`` and moved to the
device, ``apply`` runs on both, and the results are compared (chip_smoke.py
phases 18, 20 and 21 run these at full size on the card,
tests/test_torch_cuda_stochastic.py at a small size).

Tolerances: the shuffle permutation, live masks, voxels and weights equal;
offsets and momenta of a collision op to 1e-5 max|u| (the inter-species
j-side deltas are float atomics on the card); child_langmuir's new lanes to
atol 3e-5 (their weights, sqrt(|E|^3) of the interpolated field, to 1e-6
of themselves: float32 rounding), rhob and acc to 1e-5 of their largest
value (tests/test_pallas.py:65-72); aged injection's lanes to atol 2e-6
(tests/test_inject_age.py:75).  Each check returns its largest error and
raises AssertionError naming what disagreed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import collision as C
from ..grid import partition_periodic_box
from ..ops import ta_collide as TA
from ..state import FIELD_NAMES, SPECIES_NAMES, SpeciesParams, SpeciesState

MOM_RTOL = 1e-5
LANE_ATOL = 3e-5
AGED_ATOL = 2e-6
FIELD_RTOL = 1e-5
WEIGHT_RTOL = 1e-6


def to(tree, device):
    """A copy of a tensor, or of a dict / list / tuple of them, on
    ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to(v, device) for v in tree)
    if isinstance(tree, SpeciesState):
        return tree.replace(**{n: to(getattr(tree, n), device)
                               for n in SPECIES_NAMES})
    return tree


def collision_grid(n_cells: int = 16, dt: float = 0.05):
    """scripts/bench_collision.py's box: a periodic unit cube."""
    return dataclasses.replace(partition_periodic_box(
        0, 0, 0, 1, 1, 1, n_cells, n_cells, n_cells), dt=dt)


def collision_species(n: int, g, uth: float = 0.2, seed: int = 0,
                      device="cpu") -> SpeciesState:
    """scripts/bench_collision.py's make_species: n thermal lanes in random
    interior voxels, every slot live."""
    rng = np.random.default_rng(seed)
    vox = rng.integers(0, g.nx, (3, n))
    lin = (1 + vox[0]) + g.NX * ((1 + vox[1]) + g.NY * (1 + vox[2]))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    return SpeciesState(
        dx=f32(rng.uniform(-1, 1, n)), dy=f32(rng.uniform(-1, 1, n)),
        dz=f32(rng.uniform(-1, 1, n)),
        i=torch.from_numpy(lin.astype(np.int32)).to(device),
        ux=f32(rng.normal(0, uth, n)), uy=f32(rng.normal(0, uth, n)),
        uz=f32(rng.normal(0, uth, n)), w=f32(np.ones(n)),
        live=torch.ones(n, dtype=torch.bool, device=device),
        np=torch.tensor(n, dtype=torch.int32, device=device))


def collision_ops(g, n: int) -> dict:
    """The four models of scripts/bench_collision.py on species 0 (mass 1),
    and T&A between species 1 (mass 4) and 0, whose j side is a
    scatter-add: {name: op}."""
    a = SpeciesParams("a", 1.0, 1.0, n, id=0)
    b = SpeciesParams("b", -1.0, 4.0, n, id=1)
    return {
        "hard_sphere": C.make_binary_op(C.hard_sphere_model(0.3, 0.3), 0, 0,
                                        a, a),
        "takizuka_abe": C.make_takizuka_abe_op(0, 0, a, a, g,
                                               log_lambda=10.0, n0=float(n)),
        "takizuka_abe_inter": C.make_takizuka_abe_op(
            1, 0, b, a, g, log_lambda=10.0, n0=float(n)),
        "large_angle_coulomb": C.make_binary_op(
            C.large_angle_coulomb_model(1.0, 1.0, 1.0, 1.0, 0.1), 0, 0, a, a),
        "langevin": C.make_langevin_op(0, a, kT=0.04, nu=2.0),
    }


def _apply(op, species, g, draws):
    out = op.apply(species, g, draws)
    return out[0] if isinstance(out, tuple) else out


def _close(a, b, rtol, what):
    """max |a - b| over the entries that are not NaN in a (NaN where a has
    it), against rtol * max|a|; returns it."""
    a, b = a.double().cpu(), b.double().cpu()
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        raise AssertionError(f"{what}: NaN in other lanes")
    a, b = a[~nan], b[~nan]
    err = float((a - b).abs().max()) if a.numel() else 0.0
    bound = rtol * max(float(a.abs().max()) if a.numel() else 0.0, 1e-30)
    if not err <= bound:
        raise AssertionError(f"{what}: max abs err {err} > {bound}")
    return err


def compare_collision_op(op, species, g, device, seed: int = 0) -> float:
    """One application of ``op`` to ``species`` (on the CPU) on the CPU
    and on ``device`` with the same CPU-made draws: the shuffle
    permutation, live masks, voxels, weights and offsets equal, momenta to
    MOM_RTOL max|u|.  Returns the largest momentum error."""
    draws = op.draw(torch.Generator().manual_seed(seed), species)
    if isinstance(draws, list):
        r = draws[0]["shuf_i"]
        k = op.pair[0]
        perm_h = C.shuffle_sort(species[k], r)[1]
        perm_d = C.shuffle_sort(to(species[k], device), to(r, device))[1]
        if not torch.equal(perm_h, perm_d.cpu()):
            raise AssertionError("the shuffle permutation differs")
    out_h = _apply(op, to(species, "cpu"), g, draws)
    out_d = _apply(op, to(species, device), g, to(draws, device))
    err = 0.0
    for k, (a, b) in enumerate(zip(out_h, out_d)):
        for n in ("live", "i", "w", "dx", "dy", "dz"):
            if not torch.equal(getattr(a, n), getattr(b, n).cpu()):
                raise AssertionError(f"species {k}.{n} differs")
        for n in ("ux", "uy", "uz"):
            err = max(err, _close(getattr(a, n), getattr(b, n), MOM_RTOL,
                                  f"species {k}.{n}"))
    return err


def compare_order(sp, key, g) -> None:
    """The T&A kernels' order pass (ops/ta_collide.shuffle_order) of ``sp``
    (on the card) with shuffle keys ``key`` against the plain op's
    shuffle_sort and cell_partition on the same card: the permutation and
    the voxels' starts and counts equal."""
    got = TA.shuffle_order(sp.live, sp.i, key, g.nv)
    shuffled, perm = C.shuffle_sort(sp, key)
    start, count = C.cell_partition(shuffled, g)
    first, cnt = TA.voxel_partition(got, g.nv)
    if not torch.equal(got.order.long(), perm):
        raise AssertionError("the order pass's permutation differs")
    if not (torch.equal(first.long(), start)
            and torch.equal(cnt.long(), count)):
        raise AssertionError("the order pass's voxel partition differs")


def compare_routes(op, species, g, draws) -> float:
    """``op.apply`` (a T&A op on card tensors: its hand kernels, route
    "cuda") against ``op.apply_plain`` on the same card from the same
    ``draws``: the shuffled slots' live masks, voxels, weights and offsets
    equal, momenta to MOM_RTOL max|u| (the plain op's j sums are float
    atomics).  Returns the largest momentum error."""
    hand = _apply(op, species, g, draws)
    if op.route != "cuda":
        raise AssertionError(f"the op took the {op.route} route on the card")
    plain = op.apply_plain(species, g, draws)[0]
    err = 0.0
    for k, (a, b) in enumerate(zip(plain, hand)):
        for n in ("live", "i", "w", "dx", "dy", "dz"):
            if not torch.equal(getattr(a, n), getattr(b, n)):
                raise AssertionError(f"species {k}.{n} differs")
        for n in ("ux", "uy", "uz"):
            err = max(err, _close(getattr(a, n), getattr(b, n), MOM_RTOL,
                                  f"species {k}.{n}"))
    return err


def _turns(fns, n: int) -> dict:
    """{name: (CUDA-event ms, device ms, launches)} per call of each of
    ``fns`` ({name: fn}), taken in turns: forward, then backward, the two
    readings of each averaged."""
    from . import cuda_ms, device_kernels
    got = {k: [] for k in fns}
    for names in (list(fns), list(fns)[::-1]):
        for k in names:
            kern = device_kernels(fns[k], n)
            got[k].append((cuda_ms(fns[k], n),
                           sum(ms for _, ms in kern.values()),
                           sum(c for c, _ in kern.values())))
    return {k: tuple(sum(v) / len(v) for v in zip(*r)) for k, r in
            got.items()}


def time_routes(op, species, g, draws, n: int = 5) -> dict:
    """The op's apply by each route on the card, in turns (plain, hand,
    hand, plain): {"cuda": (CUDA-event ms, device ms, launches), "plain":
    ...} per apply, from the same draws."""
    return _turns({"plain": lambda: op.apply_plain(species, g, draws),
                   "cuda": lambda: op.apply(species, g, draws)}, n)


def time_index_add(op, species, g, draws, n: int = 5) -> dict:
    """The plain interspecies op's j-side scatter, one momentum component's
    ``index_add_`` (the plain op runs three): as the op runs it, every
    i-lane adding into its partner slot (a dead i-lane, voxel 0 after the
    shuffle's gather, at voxel 0's j-lanes), and masked to the paired live
    i-lanes.  Returns {"unmasked": (CUDA-event ms, device ms, launches),
    "masked": ..., "lanes": i-lanes, "paired": paired i-lanes,
    "at_voxel0": i-lanes whose partner index is voxel 0's first}."""
    i, j = op.pair
    d = draws[0]
    si = C.shuffle_sort(species[i], d["shuf_i"])[0]
    sj = C.shuffle_sort(species[j], d["shuf_j"])[0]
    start_i, _ = C.cell_partition(si, g)
    start_j, cnt_j = C.cell_partition(sj, g)
    vox = si.i.long()
    rank = torch.arange(si.capacity, device=vox.device) - start_i[vox]
    ib = start_j[vox] + rank % torch.clamp(cnt_j[vox], min=1)
    same = si.live & (cnt_j[vox] > 0)
    src = torch.full_like(si.ux, 1e-7)
    u = sj.ux.clone()
    ib_m, src_m = ib[same], src[same]
    got = _turns({"unmasked": lambda: u.index_add_(0, ib, src),
                  "masked": lambda: u.index_add_(0, ib_m, src_m)}, n)
    got.update(lanes=si.capacity, paired=int(same.sum()),
               at_voxel0=int((ib == start_j[0]).sum()))
    return got


def compare_lanes(a, b, atol, what, acc=None, rhob=None, w_rtol=0.0):
    """Lanes ``a`` (CPU) against ``b``: live masks and voxels equal,
    weights to ``w_rtol`` of themselves (equal by default), offsets and
    momenta of the live lanes to ``atol``; acc and rhob pairs to FIELD_RTOL
    of their largest value.  Returns the largest lane error."""
    for n in ("live", "i"):
        if not torch.equal(getattr(a, n).cpu(), getattr(b, n).cpu()):
            raise AssertionError(f"{what}: {n} differs")
    wa, wb = a.w.cpu().double(), b.w.cpu().double()
    werr = float(((wa - wb).abs() / wa.abs().clamp(min=1e-30)).max())
    if not werr <= w_rtol:
        raise AssertionError(f"{what}: w differs by {werr} of itself")
    if int(a.np) != int(b.np):
        raise AssertionError(f"{what}: np {int(a.np)} != {int(b.np)}")
    live = a.live.cpu()
    err = 0.0
    for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
        d = (getattr(a, n).cpu()[live].double()
             - getattr(b, n).cpu()[live].double()).abs()
        e = float(d.max()) if d.numel() else 0.0
        if not e <= atol:
            raise AssertionError(f"{what}: {n} max abs err {e} > {atol}")
        err = max(err, e)
    for name, pair in (("acc", acc), ("rhob", rhob)):
        if pair is not None:
            x, y = (t.double().cpu() for t in pair)
            e = float((x - y).abs().max())
            bound = FIELD_RTOL * max(float(x.abs().max()), 1e-30)
            if not e <= bound:
                raise AssertionError(f"{what}: {name} err {e} > {bound}")
    return err


def compare_child_langmuir(sim, state, device, seed: int = 0):
    """One call of the deck's first emitter on ``state`` (a CPU state of
    ``sim``, an emission deck) on the CPU and on ``device`` with the same
    CPU-made draws.  Returns (largest lane error, new lanes)."""
    from ..ops import interp as I
    em = sim.emitters[0]
    g = sim.grid
    k = em.sp_idx
    draws = em.draw(torch.Generator().manual_seed(seed), "cpu")
    outs = []
    for dev in ("cpu", device):
        fields = state.fields.replace(**{
            n: to(getattr(state.fields, n), dev) for n in FIELD_NAMES})
        fcoef = I.load_interpolator(fields, g)
        acc = torch.zeros((g.nv, 12), device=dev)
        rhob = to(state.fields.rhob.reshape(-1), dev)
        species = to(list(state.species), dev)
        out, acc, rhob = em.apply(species, fcoef, acc, rhob, g,
                                  to(draws, dev))
        outs.append((out[k], acc, rhob))
    (a, acc_h, rhob_h), (b, acc_d, rhob_d) = outs
    new = int((a.live & ~state.species[k].live.cpu()).sum())
    err = compare_lanes(a, b, LANE_ATOL, "child_langmuir", (acc_h, acc_d),
                        (rhob_h, rhob_d), WEIGHT_RTOL)
    return err, new


def aged_wall_deck(vt, device, n: int = 3000, seed: int = 4):
    """A 16^2 deck with an absorbing +x wall and ``n`` lanes injected with
    ages, the first n / 15 of them aimed at the wall from within 0.05 of
    it (tests/test_torch_inject_age.py's deck)."""
    rng = np.random.default_rng(seed)
    lanes = np.stack([rng.uniform(0.0, 1.0, n), rng.uniform(0.0, 1.0, n),
                      rng.normal(0, 3.0, n), rng.normal(0, 3.0, n),
                      np.where(rng.uniform(size=n) < 0.2, 0.0,
                               rng.uniform(0, 1, n))], axis=1)
    m = n // 15
    lanes[:m, 0] = rng.uniform(0.95, 1.0, m)
    lanes[:m, 2] = np.abs(lanes[:m, 2]) + 20.0
    sim = vt.Simulation(seed=1, device=device)
    sim.define_units(1.0, 1.0)
    g0 = vt.partition_periodic_box(0, 0, 0, 1, 1, 1, 16, 16, 1)
    sim.define_timestep(0.5 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (16, 16, 1))
    sim.set_domain_field_bc(vt.BOUNDARY(1, 0, 0), vt.ABSORB_FIELDS)
    sim.set_domain_particle_bc(vt.BOUNDARY(1, 0, 0), vt.ABSORB_PARTICLES)
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    el = sim.define_species("e", -1.0, 1.0, 2 * n + 16, -1, 4, 1)
    for x, y, ux, uy, age in lanes:
        sim.inject_particle(el, x, y, 0.5, ux, uy, 0.0, 1.0, age=age)
    return sim


def compare_aged_initialize(vt, device, n: int = 3000):
    """initialize() of the aged wall deck on the CPU and on ``device``:
    the same lanes killed, lanes to AGED_ATOL.  Returns (largest error,
    lanes killed)."""
    a = aged_wall_deck(vt, "cpu", n).initialize().species[0]
    b = aged_wall_deck(vt, device, n).initialize().species[0]
    err = compare_lanes(a, b, AGED_ATOL, "aged initialize()")
    return err, int((~a.live[:n]).sum())
