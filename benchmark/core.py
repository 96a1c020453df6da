"""The harness: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<config>.json``: the deck, its
parameters and its plain reference) and a traffic mix
(``workloads/<traffic>.json``: how the window drives the deck); its
compared numbers' limits are ``limits/<cell>.json`` and its per-layer
metrics are read by ``metrics/<metric>.py``.  A new cell, mix or metric
is a new file and an entry in ``BENCHMARK.json``; nothing here names
one.

A run, as a user runs the deck:

1. set-up (``setup_s``): the deck built through the program's own builder
   with the seed (the host staging of its particle load), ``initialize()``,
   the step from ``Simulation.make_multi_step`` (the graphed step on the
   card), a device copy of the initial state, then warm repeats of the
   window's repeat until one meets no cadence for the first time, so that
   every graph is captured before the window opens, and where the
   configuration asks for it (``warm_profiler``) one empty profiler
   session (see ``trace.warm_profiler``);
2. the window: repeats of the deck's own run (``repeat`` steps in chunks
   of ``chunk``, as ``Simulation.run`` steps without its I/O), each
   followed by the energies of its last state and a restore of the initial
   state into the step's own tensors, for ``--seconds`` on the host clock
   (whole repeats; the last one ends past it, and the time counts it);
   with ``--trace 1`` instead ``trace_repeats`` repeats under the
   profiler;
3. the check, once the window has closed and the peak memory is read: one
   more repeat through the same step object, the states before and after
   a sample of its steps kept with the random draws the program made in
   each (``step_draws``), the program freed, and the plain reference
   (``check.py``; the step of the configuration's reference module where
   it has one, fed those draws, else ``reference/pic.step``) run against
   those states and against the initial state.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import check, trace
from .reference import pic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may have loaded once its window has
# closed: JAX, and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "vpic_tpu", "bench")


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Spec:
    """A cell as BENCHMARK.json and its files give it."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def spec(name: str, root: Path = ROOT) -> Spec:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(m):
        return name in m.get("workloads", [name])

    return Spec(name=name, cell=cell, config=load_json(root / cfg["file"]),
                traffic=load_json(HERE / "workloads"
                                  / f"{cell['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def metric_module(metric: str):
    """The module ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py``."""
    return metric_module(metric).read


def hand_kernels() -> List[str]:
    """The names of the port's hand-written kernels: every ``KERNELS`` of
    a file in metrics/ (a roofline names the kernels that do its stage)
    and every ``OTHER_HAND`` (the hand kernels no roofline times)."""
    names = set()
    for path in sorted((HERE / "metrics").glob("*.py")):
        mod = metric_module(path.stem)
        names.update(getattr(mod, "KERNELS", ()))
        names.update(getattr(mod, "OTHER_HAND", ()))
    return sorted(names)


def reference(config: dict):
    """The configuration's plain reference module."""
    return importlib.import_module(f"benchmark.reference."
                                   f"{config['reference']}")


def forbidden_loaded() -> List[str]:
    """The loaded modules whose top-level name is a FORBIDDEN one (whole
    names: vpic_tpu_torch is not vpic_tpu)."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


@dataclass
class Run:
    """What the readers in metrics/ see of a run."""

    device_kind: str = ""
    times: Dict[str, float] = field(default_factory=dict)
    rebuckets_per_repeat: Optional[float] = None
    timeline: Optional[trace.Timeline] = None
    lanes: List[int] = field(default_factory=list)
    cells: int = 0
    geom: Optional[pic.Geom] = None
    # per checked step: (voxels before, the reference's voxels after), one
    # pair of tensors a species, in the reference's lane order
    moves: list = field(default_factory=list)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _resolve(v, sim) -> int:
    """A traffic setting: a whole number, or the name of the Simulation
    attribute that gives it (``num_step``, ``status_interval``)."""
    return int(getattr(sim, v)) if isinstance(v, str) else int(v)


def build(config: dict, device):
    """The deck through the program's own builder, its particle load drawn
    from the configuration's ``load_seed``."""
    prog = config["program"]
    mod = importlib.import_module(prog["module"])
    params = getattr(mod, prog["params"])(**config["params"],
                                          seed=config["load_seed"])
    return mod.build(params, device=device)


def orders(seed: int, counts: List[int]) -> List[torch.Tensor]:
    """The run's order of each species' initial lanes, drawn from the
    seed: one permutation of the first ``count`` lanes a species, the
    same for species of one count (the pairs stay pairs).

    Every seed runs the same particles, so the same physics and the same
    work; what the seed draws is the order the deck would have injected
    them in, which moves every lane's slot, the relayouts' inputs and the
    deposits' order."""
    gen = torch.Generator().manual_seed(seed)
    drawn: Dict[int, torch.Tensor] = {}
    for n in counts:
        if n not in drawn:
            drawn[n] = torch.randperm(n, generator=gen)
    return [drawn[n] for n in counts]


def permute(state, perms):
    """The initial state's lanes put in the given orders, in place."""
    from vpic_tpu_torch.state import SPECIES_NAMES
    for sp, perm in zip(state.species, perms):
        idx = perm.to(sp.dx.device)
        for name in SPECIES_NAMES:
            t = getattr(sp, name)
            if t.dim():
                t[:len(idx)] = t[:len(idx)][idx]


def clone_state(state):
    from vpic_tpu_torch.state import (FIELD_NAMES, SPECIES_NAMES,
                                      FieldState, SimState, SpeciesState)
    f = FieldState(*[getattr(state.fields, n).clone() for n in FIELD_NAMES])
    species = tuple(SpeciesState(*[getattr(sp, n).clone()
                                   for n in SPECIES_NAMES])
                    for sp in state.species)
    diag = {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in state.diag.items()}
    return SimState(fields=f, species=species, step=state.step, diag=diag,
                    rng=state.rng)


def restore(state, snap):
    """``snap`` copied into ``state``'s own tensors (the graphs replay on
    them), with its step and host diag entries."""
    from vpic_tpu_torch.state import FIELD_NAMES, SPECIES_NAMES, SimState
    for n in FIELD_NAMES:
        getattr(state.fields, n).copy_(getattr(snap.fields, n))
    for a, b in zip(state.species, snap.species):
        for n in SPECIES_NAMES:
            getattr(a, n).copy_(getattr(b, n))
    diag = {k: state.diag[k].copy_(v) if isinstance(v, torch.Tensor) else v
            for k, v in snap.diag.items()}
    return SimState(fields=state.fields, species=state.species,
                    step=snap.step, diag=diag, rng=state.rng)


def plain(state, sim):
    """A copy of the state in the reference's plain form: the 16 field
    arrays and each species' live lanes with its charge and mass."""
    f = {n: getattr(state.fields, n).clone() for n in pic.FIELD_NAMES}
    out = []
    for st, sp in zip(sim.species, state.species):
        d = {n: getattr(sp, n)[sp.live] for n in pic.LANE_NAMES}
        d.update(q=st.params.q, m=st.params.m)
        out.append(d)
    return f, out


class Runner:
    """The window's loop over one deck: repeats of ``repeat`` steps in
    chunks of ``chunk``, the energies of each repeat's last state, and a
    restore of the initial state."""

    def __init__(self, sim, state, traffic: dict, labels: bool = False):
        from vpic_tpu_torch import step_graph
        self.sim = sim
        self.device = state.fields.ex.device
        self.repeat_len = _resolve(traffic["repeat"], sim)
        self.chunk = _resolve(traffic["chunk"], sim)
        self.many = sim.make_multi_step(self.chunk)
        rest = self.repeat_len % self.chunk
        self.rest = step_graph.multi(self.many.step, rest) if rest else None
        self.one = step_graph.multi(self.many.step, 1)
        self.state = state
        self.snap = clone_state(state)
        self.lanes = [int(sp.np) for sp in state.species]
        self.e0 = float(sim.energies(self.snap).double().sum())
        # per repeat: the energies of its last state, its rebuckets, and
        # (on the card) an event recorded as it ends, after one recorded
        # as the window opens
        self.energies: List[torch.Tensor] = []
        self.rebuckets: List[torch.Tensor] = []
        self.marks: list = []
        self.repeats = 0
        self._label = torch.profiler.record_function if labels else \
            (lambda _name: contextlib.nullcontext())

    def repeat(self):
        s = self.state
        with self._label(trace.STEPS):
            for _ in range(self.repeat_len // self.chunk):
                s = self.many(s)
            if self.rest is not None:
                s = self.rest(s)
        with self._label(trace.BETWEEN[0]):
            self.energies.append(self.sim.energies(s))
        with self._label(trace.BETWEEN[1]):
            if "_res_rebuckets" in s.diag:
                self.rebuckets.append(s.diag["_res_rebuckets"].clone())
            self.state = restore(s, self.snap)
        self.repeats += 1
        self.mark()

    def mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)

    def reset_counts(self):
        self.energies.clear()
        self.rebuckets.clear()
        self.marks.clear()
        self.repeats = 0

    def repeat_ms(self) -> List[float]:
        """Each repeat's device time between the events around it."""
        return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]

    def drifts(self) -> List[float]:
        """Each repeat's relative change of the total energy."""
        return [abs(float(e.double().sum()) - self.e0) / abs(self.e0)
                for e in self.energies]

    def cadence(self, k: int, diag):
        step = self.many.step
        return getattr(step, "advance", step).cadence(k, diag)


def warm(drv: Runner, most: int = 4):
    """Repeats until one runs no step eagerly (every cadence it meets was
    met before, so the repeat captured or replayed each)."""
    for _ in range(most):
        before = getattr(drv.many.step, "eager_steps", None)
        drv.repeat()
        if before is None or drv.many.step.eager_steps == before:
            _sync(drv.device)
            drv.reset_counts()
            return
    raise RuntimeError(f"the step still ran eager warm-ups after {most} "
                       "repeats")


def window(drv: Runner, seconds: float):
    """Whole repeats until ``seconds`` have passed on the host clock;
    (steps, seconds) with the device's work finished."""
    _sync(drv.device)
    drv.mark()
    t0 = time.perf_counter()
    while True:
        drv.repeat()
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(drv.device)
    return drv.repeats * drv.repeat_len, time.perf_counter() - t0


def traced(drv: Runner, repeats: int) -> trace.Timeline:
    with trace.profiled() as prof:
        with torch.profiler.record_function(trace.WINDOW):
            drv.mark()
            for _ in range(repeats):
                drv.repeat()
            torch.cuda.synchronize()
    return trace.Timeline.from_profiler(prof, repeats * drv.repeat_len)


def step_draws(sim, k: int, saved, before, sorts, species, deck: str = ""):
    """The random draws of step ``k`` in plain form, remade from ``saved``,
    the state of the program's generator before the step, or None when
    the step drew nothing.

    The draws are remade by the program's own ``draw`` of each collision
    op that fires at step ``k``, in the step's order, on a clone of the
    generator; the clone has to end where the program's generator ended,
    or the program drew something that is not remade here, and the run
    stops.  Each op gives one dict: ``pair`` (its species i and j),
    ``interval``, ``q`` and ``m`` (of i and j) and ``rounds``, one dict a
    pairing round: ``shuf_i`` (and ``shuf_j`` between species), the
    shuffle keys of the live lanes, and the per-pair variates cut to the
    pairs of the shuffled live lanes (the first n // 2 within a species,
    n between species, for n live i-lanes).

    The keys are the slots' keys of the live lanes in the order the
    species has as the op shuffles it.  ``before`` gives each species'
    live mask and its live lanes' voxels before the step.  A species that
    no op has shuffled yet in the step lies in its slots, so its keys are
    in ``plain()``'s order; where ``sorts`` says the step sorted it by
    voxel before its collision ops (the general path's ``sort_p``,
    ``Cadence.sorts``), its live lanes lie packed in that stable sort,
    and their keys are put back in ``plain()``'s order.  A shuffle leaves
    them packed in its own order, which the reference's shuffle gives
    too."""
    gen = sim._generator
    if gen is None or torch.equal(saved, gen.get_state()):
        return None
    where = f"{deck or 'the deck'}, step {k}"
    clone = torch.Generator(device=gen.device)
    clone.set_state(saved)
    live = [m for m, _ in before]
    counts = [int(m.sum()) for m in live]
    lay = ["sorted" if s else "slots" for s in sorts] + \
        ["slots"] * (len(live) - len(sorts))

    def keys(shuf, sp):
        n = counts[sp]
        if lay[sp] == "slots":
            out = shuf[live[sp]]
        else:
            out = shuf[:n]
            if lay[sp] == "sorted":
                order = torch.sort(before[sp][1], stable=True).indices
                out = torch.empty_like(out).index_copy_(0, order, out)
        lay[sp] = "shuffled"
        return out

    ops = []
    for op in sim.collision_ops:
        interval = int(getattr(op, "interval", 0))
        if interval <= 0 or k % interval:
            continue
        if not hasattr(op, "pair"):
            raise RuntimeError(f"{where}: the collision op {op!r} fires, and "
                               "the check remakes the draws of binary ops "
                               "only")
        i, j = op.pair
        rounds = []
        for d in op.draw(clone, species):
            r = {"shuf_i": keys(d["shuf_i"], i)}
            if i != j:
                r["shuf_j"] = keys(d["shuf_j"], j)
            n = counts[i] // 2 if i == j else counts[i]
            r.update({key: v[:n] for key, v in d.items()
                      if not key.startswith("shuf")})
            rounds.append(r)
        params = [sim.species[sp].params for sp in (i, j)]
        ops.append(dict(pair=(i, j), interval=interval,
                        q=tuple(p.q for p in params),
                        m=tuple(p.m for p in params), rounds=rounds))
    if not torch.equal(clone.get_state(), gen.get_state()):
        raise RuntimeError(f"{where}: the program's generator moved past the "
                           "draws of the collision ops that fire; the check "
                           "cannot judge a step whose draws it does not know")
    return ops


def check_repeat(drv: Runner, traffic: dict, seed: int, deck: str = ""):
    """One more repeat through the window's step object, one step a call:
    (the initial state, [(k, before, after, draws)]) in plain form for
    step 0, the repeat's last step and ``per_cadence`` steps drawn from
    the seed of each cadence the other steps meet; ``draws`` is the
    step's random draws (``step_draws``), None where it drew nothing."""
    sim, n = drv.sim, drv.repeat_len
    start = plain(drv.snap, sim)
    s = drv.state
    gen = sim._generator
    picks = {0}
    rng = random.Random(seed)
    out = []
    for k in range(n):
        if k == 1:
            groups: Dict[object, List[int]] = {}
            for j in range(1, n - 1):
                groups.setdefault(drv.cadence(j, s.diag), []).append(j)
            for steps in groups.values():
                picks.update(rng.sample(steps, min(len(steps),
                                                   traffic["per_cadence"])))
            picks.add(n - 1)
        if k > max(picks) and k > 0:
            break
        pre = None
        if k in picks:
            pre = plain(s, sim)
            saved = None if gen is None else gen.get_state()
            before = [(sp.live.clone(), d["i"])
                      for sp, d in zip(s.species, pre[1])]
            sorts = getattr(drv.cadence(k, s.diag), "sorts", ())
        s = drv.one(s)
        if pre is not None:
            draws = None if gen is None else step_draws(
                sim, k, saved, before, sorts, s.species, deck)
            out.append((k, pre, plain(s, sim), draws))
    drv.state = restore(s, drv.snap)
    return start, out


def _flipped(draws: List[dict], ids: torch.Tensor) -> List[dict]:
    """The draws with each op's ``flip``: the codes of the pairs of
    ``ids`` (``op << 36 | code``, as the reference marks them) in it."""
    out = []
    for n, op in enumerate(draws):
        mine = ids[ids >> 36 == n] & ((1 << 36) - 1)
        out.append(dict(op, flip=mine) if mine.numel() else op)
    return out


def settle(ref_step, pre, post, k: int, draws, got, g):
    """The reference's step where it marks two-valued pairs (each lane's
    ``two_valued``, the id of its pair, else -1: a pair whose outcome
    rounding decides, see reference/collision.py): each such pair takes
    the branch whose lanes lie nearer the program's after the step.  A
    second step takes the other branch of every marked pair; a pair keeps
    it where its lanes' partner distances (check.partner_errs) sum less
    there.  Returns (draws with the branches taken, the reference's
    fields, species)."""
    rf, rs = got
    marks = [sp.get("two_valued") for sp in rs]
    if any(m is None for m in marks):
        return draws, rf, rs
    ids = torch.cat([m[m >= 0] for m in marks]).unique()
    if not ids.numel():
        return draws, rf, rs
    other = _flipped(draws, ids)
    rf2, rs2 = ref_step(pre[0], pre[1], k, other)
    score = []
    for out in (rs, rs2):
        total = torch.zeros(ids.numel(), dtype=torch.float64,
                            device=ids.device)
        for m, e in zip(marks, check.partner_errs(post[1], out, g)):
            on = m >= 0
            total.index_add_(0, torch.searchsorted(ids, m[on]),
                             e[on].to(total.device))
        score.append(total)
    take = ids[score[1] < score[0]]
    if not take.numel():
        return draws, rf, rs
    if take.numel() == ids.numel():
        return other, rf2, rs2
    draws = _flipped(draws, take)
    return (draws,) + tuple(ref_step(pre[0], pre[1], k, draws))


def compare(config: dict, seed: int, start, samples, device,
            control: bool = False):
    """The compared numbers of each check of the program's states (the
    start, then each sampled step), and with ``control`` the worst of
    those of the reference computed in bfloat16 in the program's place;
    also each checked step's voxels before and after (the reference's).

    The reference's step is the configuration's reference module's
    ``step(fields, species, g, k, draws)``, fed the draws the program
    made at step ``k``, where the module defines one, else ``pic.step``;
    pairs it marks two-valued take the branch the program's lanes match
    (``settle``), and the control goes through the same step with the
    same draws and branches."""
    ref = reference(config)
    g = ref.geom(config["params"])
    deck_step = getattr(ref, "step", None)

    def ref_step(fields, species, k, draws):
        if deck_step is None:
            return pic.step(fields, species, g, k)
        return deck_step(fields, species, g, k, draws)

    floors = ref.field_scales(config["params"])
    per, ctrl = [], check.empty() if control else None
    f0, s0 = ref.initial_state(config["params"], config["load_seed"], device)
    s0 = [dict(sp, **{k: sp[k][perm.to(sp[k].device)] for k in pic.LANE_NAMES})
          for sp, perm in zip(s0, orders(seed, [len(sp["w"]) for sp in s0]))]
    got = check.lane_errs(start[1], s0, g, ordered=True)
    got.update(check.field_errs(start[0], f0, ("e_err", "b_err", "rho_err"),
                                floors))
    per.append(got)
    del f0, s0
    moves = []
    for k, pre, post, draws in samples:
        got = ref_step(pre[0], pre[1], k, draws)
        draws, rf, rs = settle(ref_step, pre, post, k, draws, got, g)
        groups = ("e_err", "b_err", "jf_err")
        if g.clean_interval > 0 and k % g.clean_interval == 0:
            groups += ("rho_err",)
        got = check.lane_errs(post[1], rs, g)
        got.update(check.field_errs(post[0], rf, groups, floors))
        per.append(got)
        moves.append(([sp["i"] for sp in pre[1]], [sp["i"] for sp in rs]))
        if control:
            cf, cs = ref_step(*pic.in_dtype(pre[0], pre[1], torch.bfloat16),
                              k, draws)
            cf, cs = pic.in_dtype(cf, cs, torch.float32)
            check.merge(ctrl, check.lane_errs(cs, rs, g))
            check.merge(ctrl, check.field_errs(cf, rf, groups, floors))
    return per, ctrl, moves, g


def free(drv: Runner):
    """Drops the program's state, graphs and pools."""
    drv.sim = drv.many = drv.rest = drv.one = None
    drv.state = drv.snap = None
    gc.collect()
    if drv.device.type == "cuda":
        torch.cuda.empty_cache()


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def setup(sp: Spec, seed: int, device, labels: bool = False):
    """The deck built, initialized and warmed: (the runner, {stage: seconds})."""
    times = {}
    t = time.perf_counter()
    sim = build(sp.config, device)
    times["staging_s"] = time.perf_counter() - t
    t = time.perf_counter()
    state = sim.initialize()
    _sync(device)
    times["initialize_s"] = time.perf_counter() - t
    permute(state, orders(seed, [int(p.np) for p in state.species]))
    t = time.perf_counter()
    drv = Runner(sim, state, sp.traffic, labels=labels)
    warm(drv)
    times["capture_s"] = time.perf_counter() - t
    if sp.config.get("warm_profiler") and \
            torch.device(device).type == "cuda":
        t = time.perf_counter()
        trace.warm_profiler()
        times["warm_profiler_s"] = time.perf_counter() - t
    return drv, times


def run_cell(sp: Spec, seed: int, seconds: float, traced_run: bool,
             device="cuda", t0: float = None, kind: str = "") -> dict:
    """One run; returns the result's fields (see run.py)."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    run = Run(device_kind=kind)
    drv, run.times = setup(sp, seed, device, labels=traced_run)
    run.times["setup_s"] = time.perf_counter() - t0
    run.lanes = drv.lanes
    graphed = getattr(drv.many, "graphed", None)
    log(f"set-up {run.times['setup_s']:.3f} s: staging "
        f"{run.times['staging_s']:.3f}, initialize "
        f"{run.times['initialize_s']:.3f}, warm repeats "
        f"{run.times['capture_s']:.3f}, empty profiler session "
        f"{run.times.get('warm_profiler_s', 0.0):.3f}; step "
        f"graphed={graphed}, path={drv.many.path}, repeat "
        f"{drv.repeat_len} steps in chunks of {drv.chunk}, lanes {drv.lanes}")

    if traced_run:
        run.timeline = traced(drv, int(sp.traffic["trace_repeats"]))
        steps, secs = run.timeline.steps, run.timeline.window_us / 1e6
    else:
        steps, secs = window(drv, seconds)
    repeats = drv.repeats
    peak = torch.cuda.max_memory_reserved() if device.type == "cuda" else 0
    rebuckets = [int(n) for n in drv.rebuckets]
    if rebuckets:
        run.rebuckets_per_repeat = sum(rebuckets) / repeats
    ms = drv.repeat_ms()
    for r, d in enumerate(drv.drifts()):
        log(f"repeat {r}: relative energy drift {d!r}"
            + (f", rebuckets {rebuckets[r]}" if rebuckets else "")
            + (f", {ms[r]!r} device ms" if ms else ""))
    log(f"window: {repeats} repeats, {steps} steps in {secs!r} s")

    start, samples = check_repeat(drv, sp.traffic, seed,
                                  sp.config.get("name", sp.name))
    free(drv)
    t = time.perf_counter()
    per, _, run.moves, run.geom = compare(sp.config, seed, start, samples,
                                          device)
    for what, got in zip(["start"] + [f"step {k}" for k, *_ in samples],
                         per):
        log(f"check {what}: " + ", ".join(f"{k} {v!r}"
                                          for k, v in got.items()))
    nums = check.empty()
    for got in per:
        check.merge(nums, got)
    run.cells = run.geom.nx * run.geom.ny * run.geom.nz
    log(f"check: steps {[k for k, *_ in samples]} and the start, "
        f"{time.perf_counter() - t:.3f} s")
    ok, rows = check.judge(nums, sp.limits)

    pushes = sum(run.lanes) * steps
    if traced_run:
        metrics = {}
        for m in sp.per_layer:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"pushes_per_s": pushes / secs,
                  "setup_s": run.times["setup_s"],
                  "peak_mem_mib": peak / 2 ** 20}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in sp.end_to_end}
    failed = sum(not check.judge(dict(check.empty(), **got), sp.limits)[0]
                 for got in per)
    out = {"correct": ok, "attempted": len(per), "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": kind, "count": 1,
                      "memory_peak_bytes": peak}}
    if traced_run:
        out["device"]["busy_s"] = run.timeline.busy_us() / 1e6
        out["device"]["window_s"] = secs
        out["breakdown"] = run.timeline.breakdown()
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return out
