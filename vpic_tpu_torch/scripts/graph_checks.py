"""Checks of the graphed step (``step_graph``) against the eager step, used
by chip_smoke.py phase 29 on the card at the decks' main-path sizes and by
tests/test_torch_cuda_graph.py at small sizes; their CPU parts by
tests/test_torch_graph_step.py.

* ``build(name, device, **params)``: the decks phase 29 runs.
* ``refusals()``: step_graph.refusal of every one-domain deck of the
  repository, built for the card (nothing is initialized).
* ``graphed_vs_eager(sim, state, n)``: from one state (the graphed step's
  own, once the cadence of its step is captured), one step graphed and one
  eager from a copy, with equal generator states: the lanes must be equal
  bit for bit (the push of a lane is the same arithmetic; only the
  deposits' float atomics reorder, and they reach no lane in one step).
  Then ``n`` - 1 more steps each way, each from the generator's state
  after the first: fields to 5e-7 + 1e-5 max|a| (tests/test_pallas.py:
  88-94).
* ``force_rebucket(sim, state)``: moves the live lanes of species 0's first
  residency block into the brick next to their home along x, so that the
  next push finds more leavers in that block than its outbox holds and
  the step must rebucket.
"""

from __future__ import annotations

import time

import torch

from .. import step_graph as SG
from ..deck import Simulation
from . import device_averages, profile_window
from ..ops.fused_push3d import BLOCK, OUT_CAP
from ..state import FIELD_NAMES, SPECIES_NAMES, FieldState, SimState, \
    SpeciesState

FIELD_RTOL, FIELD_ATOL = 1e-5, 5e-7
CHECK_FIELDS = ("jfx", "ex", "ey", "cbz")


def build(name: str, device, **params) -> Simulation:
    """harris2d (64^2 x 64 ppc), harris3d (32^3 x 128 ppc, residency),
    residency16 (16^3 x 4 ppc harris, one slack block a brick),
    reconnection (32^3 x 128 ppc, tau 5) and emission (the diode) at the
    main path's sizes, ``params`` over them."""
    from ..models import emission, harris, reconnection
    if name == "harris2d":
        return harris.build(harris.HarrisParams(**params), device=device)
    if name == "harris3d":
        kw = dict(nx=32, ny=32, nz=32, nppc=128, Lx=16.0, Ly=16.0, Lz=16.0)
        return harris.build(harris.HarrisParams(**dict(kw, **params)),
                            device=device)
    if name == "residency16":
        kw = dict(nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0,
                  headroom=3.0)
        return harris.build(harris.HarrisParams(**dict(kw, **params)),
                            device=device)
    if name == "reconnection":
        kw = dict(nx=32, ny=32, nz=32, nppc=128, Lx=16.0, Ly=16.0, Lz=4.0,
                  tau_coll_interval=5)
        return reconnection.build(
            reconnection.ReconnectionParams(**dict(kw, **params)),
            device=device)
    if name == "emission":
        return emission.build(emission.EmissionParams(**params),
                              device=device)
    raise ValueError(f"unknown deck {name!r}")


def refusals() -> dict:
    """{deck: step_graph.refusal} for every one-domain deck of the port,
    each built for the card at a small size (the reason depends on the
    deck's features, not its size; nothing touches the card)."""
    from ..models import (asymm4sp, beam_plas, cygnus, dipole, emission,
                          force_free, harris, lpi, reconnection, sc08,
                          shapes, twostream, waveguide, weibel, weibel_gold)
    decks = dict(
        harris2d=lambda: harris.build(harris.HarrisParams(
            nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0)),
        harris3d=lambda: harris.build(harris.HarrisParams(
            nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0)),
        reconnection=lambda: reconnection.build(
            reconnection.ReconnectionParams(nx=16, ny=16, nz=8, nppc=4,
                                            Lx=8.0, Ly=8.0)),
        emission=lambda: emission.build(emission.EmissionParams(
            nx=16, ny=4, Lx=0.5, Ly=0.125)),
        weibel=lambda: weibel.build(weibel.WeibelParams(nx=16, ny=16)),
        twostream=lambda: twostream.build(twostream.TwoStreamParams()),
        weibel_gold=lambda: weibel_gold.build(
            weibel_gold.WeibelGoldParams()),
        beam_plas=lambda: beam_plas.build(beam_plas.BeamPlasParams()),
        asymm4sp=lambda: asymm4sp.build(asymm4sp.Asymm4spParams()),
        force_free=lambda: force_free.build(force_free.ForceFreeParams()),
        shapes=lambda: shapes.build(shapes.ShapesParams()),
        sc08=lambda: sc08.build(sc08.SC08Params(nx=32, ny=8, nz=16,
                                                nppc=1)),
        lpi=lambda: lpi.build(lpi.LPIParams()),
        dipole=lambda: dipole.build(dipole.DipoleParams(n=16, L=8.0)),
        waveguide=lambda: waveguide.build(waveguide.WaveguideParams(
            nx=48, ny=8, Lx=12.0, Ly=4.0)),
        cygnus=lambda: cygnus.build(cygnus.CygnusParams()))
    return {name: SG.refusal(fn()) for name, fn in decks.items()}


def clone_state(state: SimState) -> SimState:
    """A copy of ``state`` on new tensors."""
    f = FieldState(*[getattr(state.fields, n).clone() for n in FIELD_NAMES])
    species = tuple(SpeciesState(*[getattr(sp, n).clone()
                                   for n in SPECIES_NAMES])
                    for sp in state.species)
    diag = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in state.diag.items()}
    return SimState(fields=f, species=species, step=state.step, diag=diag,
                    rng=state.rng)


def storage(state: SimState) -> dict:
    """{name: data_ptr} of every tensor the state carries."""
    out = {f"fields.{n}": getattr(state.fields, n).data_ptr()
           for n in FIELD_NAMES}
    for k, sp in enumerate(state.species):
        out.update({f"species{k}.{n}": getattr(sp, n).data_ptr()
                    for n in SPECIES_NAMES})
    out.update({f"diag.{k}": v.data_ptr() for k, v in state.diag.items()
                if isinstance(v, torch.Tensor)})
    return out


def lanes_equal(a: SimState, b: SimState) -> list:
    """The lane tensors that differ between two states (bits, live masks
    and np)."""
    bad = []
    for k, (x, y) in enumerate(zip(a.species, b.species)):
        for n in SPECIES_NAMES:
            s, t = getattr(x, n), getattr(y, n)
            if s.dtype == torch.float32:
                s, t = s.view(torch.int32), t.view(torch.int32)
            if not torch.equal(s, t):
                bad.append(f"species{k}.{n}")
    return bad


def fields_close(a: SimState, b: SimState, names=CHECK_FIELDS) -> float:
    """The largest |a - b| / (5e-7 + 1e-5 max|a|) over ``names``: < 1
    passes (tests/test_pallas.py:88-94)."""
    worst = 0.0
    for n in names:
        x = getattr(a.fields, n).double()
        y = getattr(b.fields, n).double()
        lim = FIELD_ATOL + FIELD_RTOL * float(x.abs().max())
        worst = max(worst, float((x - y).abs().max()) / lim)
    return worst


def warm_for(step, state: SimState, n: int, limit: int = 400) -> SimState:
    """Steps the graphed ``step`` until the cadence of every step of the
    next ``n`` is captured (at most ``limit`` steps); returns that state,
    from which ``step.run(state, n)`` replays only."""
    for _ in range(limit):
        cads = {step.advance.cadence(k, state.diag)
                for k in range(state.step, state.step + n)}
        if cads <= step.graphs.keys():
            return state
        state = step(state)
    raise RuntimeError(f"cadences still not captured after {limit} steps")


def timed(step_fn, state: SimState, n: int, particles: int,
          profile_steps: int = 10):
    """n steps of ``step_fn`` on the card: ms a step (host clock around
    synchronize), pushes/s, the peak device memory the window's tensors
    took (max_memory_allocated; a graph's pool holds its temporaries
    between replays, so they count as reserved, not allocated) and the
    peak the allocator held (max_memory_reserved, the graphs' pools
    included; the cache is emptied first), then
    ``profile_steps`` more under torch.profiler for the device's busy share
    and the host's launch calls (host_launches).  Returns (state, dict)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        state = step_fn(state)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out = dict(ms=sec * 1e3 / n, pushes_per_s=particles * n / sec,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20,
               reserved_mib=torch.cuda.max_memory_reserved() / 2**20)
    with profile_window() as prof:
        t0 = time.perf_counter()
        for _ in range(profile_steps):
            state = step_fn(state)
        torch.cuda.synchronize()
        win = time.perf_counter() - t0
    busy = sum(e.device_time_total for e in device_averages(prof)) / 1e6
    out.update(busy_share=busy / win,
               device_ms=busy * 1e3 / profile_steps,
               calls=host_launches(prof))
    return state, out


def graphed_vs_eager(sim: Simulation, state: SimState, n: int = 10,
                     prepare=None) -> dict:
    """One step graphed and one eager from one state, then n - 1 more each
    way (see the module docstring).  ``state`` becomes the graphed step's;
    ``prepare(sim, state)``, where given, changes the state in place
    before the compared step (force_rebucket).  Returns {"lanes": the lane
    tensors that differ after one step, "fields": fields_close after n,
    "rebuckets": (graphed, eager) in the first step, "at": the step
    compared, "steps": n}."""
    step = sim.make_step()
    if not isinstance(step, SG.GraphedStep):
        raise RuntimeError(f"the deck runs eagerly: {step.graphed}")
    state = warm_for(step, state, 1)
    if prepare is not None:
        prepare(sim, state)
    eager = sim.make_advance()
    other = clone_state(state)
    gen = sim._generator
    g0 = gen.get_state()
    r0 = _rebuckets(state)
    out_g = step(state)
    g1 = gen.get_state()
    gen.set_state(g0)
    out_e = eager(other)
    if not torch.equal(g1, gen.get_state()):
        raise AssertionError("the graphed and the eager step drew "
                             "differently from the generator")
    res = {"lanes": lanes_equal(out_g, out_e), "steps": n,
           "at": state.step,
           "rebuckets": (_rebuckets(out_g) - r0, _rebuckets(out_e) - r0)}
    # n - 1 more each way, each from the generator state after step one
    for _ in range(n - 1):
        out_g = step(out_g)
    g2 = gen.get_state()
    gen.set_state(g1)
    for _ in range(n - 1):
        out_e = eager(out_e)
    if not torch.equal(g2, gen.get_state()):
        raise AssertionError("the graphed and the eager steps drew "
                             "differently from the generator")
    res["fields"] = fields_close(out_e, out_g)
    SG.settle()
    return res


def _rebuckets(state: SimState) -> int:
    r = state.diag.get("_res_rebuckets")
    return 0 if r is None else int(r)


def force_rebucket(sim: Simulation, state: SimState) -> int:
    """Moves the live lanes of species 0's first block (slots [0, BLOCK))
    one brick along x, in place: more than OUT_CAP of them leave their
    block's home brick in the next push, so its outbox overflows and the
    step rebuckets.  Returns the lanes moved."""
    g = sim.grid
    sp = state.species[0]
    i = sp.i[:BLOCK]
    live = sp.live[:BLOCK]
    x = i % g.NX
    shifted = (x - 1 + 8) % g.nx + 1
    i.copy_(torch.where(live, i - x + shifted, i))
    moved = int(live.sum())
    if moved <= OUT_CAP:
        raise RuntimeError(f"only {moved} live lanes in the first block")
    return moved


def host_launches(prof) -> dict:
    """{"kernel": the kernel-launch API calls the host made
    (cudaLaunchKernel, cuLaunchKernel, cudaLaunchCooperativeKernel, ...),
    "graph": its cudaGraphLaunch calls} in a torch.profiler window."""
    out = {"kernel": 0, "graph": 0}
    for e in prof.key_averages():
        if e.device_type.name != "CPU":
            continue
        if e.key == "cudaGraphLaunch":
            out["graph"] += e.count
        elif e.key.startswith(("cuda", "cu")) and "Launch" in e.key and \
                "Kernel" in e.key:
            out["kernel"] += e.count
    return out


def cadence_trace(sim: Simulation, n: int) -> list:
    """(cadence, the branches the eager step took) for steps 0..n-1 of the
    deck on its own device: the 2-D bucket sort, the cleaners and the
    synchronize seen by counting their calls, the residency relayout by
    Simulation.relayouts, the collision firings by the generator's state
    (the ops are the deck's only draws)."""
    from ..ops import fields as F
    from ..ops import fused_push as FP
    calls = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        setattr(mod, name, wrapper)
        return fn

    patched = [(FP, "bucket_sort_p"), (F, "clean_div_e"),
               (F, "clean_div_b"), (F, "synchronize_tang_e_norm_b")]
    saved = [counted(m, a) for m, a in patched]
    try:
        state = sim.initialize()
        advance = sim.make_advance()
        out = []
        for _ in range(n):
            cad = advance.cadence(state.step, state.diag)
            calls.clear()
            relayouts = sim.relayouts
            g0 = sim._generator.get_state()
            state = advance(state)
            drew = not torch.equal(g0, sim._generator.get_state())
            took = dict(sort=calls.get("bucket_sort_p", 0) > 0,
                        clean_e=calls.get("clean_div_e", 0) > 0,
                        clean_b=calls.get("clean_div_b", 0) > 0,
                        sync=calls.get("synchronize_tang_e_norm_b", 0) > 0,
                        relayout=sim.relayouts > relayouts, drew=drew)
            out.append((cad, took))
        return out
    finally:
        for (m, a), fn in zip(patched, saved):
            setattr(m, a, fn)
