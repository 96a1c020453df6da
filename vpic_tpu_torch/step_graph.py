"""The compiled step: the one-domain step captured as CUDA graphs, the
port's counterpart of ``jax.jit`` around the step and of the ``lax.scan``
of ``make_multi_step`` (vpic_tpu/deck.py:1553-1583).  No JAX module
corresponds to this one.

The JAX package compiles the step into one XLA program whose decisions are
``lax.cond``s on the device.  Here the step's host-side decisions (the
sorts, the cleaners, the collision firings, the residency relayout) stay on
the host: for a step number they form the step's ``deck.Cadence``, and one
``torch.cuda.CUDAGraph`` is captured per cadence met, all in one memory
pool.  The first step of a cadence runs eagerly (it builds the kernels,
fills the caches and makes every call a capture forbids); the next step of
that cadence is captured, then replayed, and every later one is replayed.
Capture executes nothing, so every step's result is a real one.  The 3-D
residency step's device decision, rebucket or merge, is two conditional
(IF) nodes predicated on the device bool and on its negation
(``csrc/graph_cond.cu``: the CUDA runtime's conditional nodes, CUDA 12.4
and later, which the installed PyTorch does not expose): a captured step
reads nothing on the host.  Each IF body is captured from its own stream,
and what the body allocates comes from a pool of the graphed step's that
lives as long as its graphs.

The graphs read and write the tensors of one state, the step's own (the
step keeps every tensor's storage, ``Simulation.make_advance``).  A call
with a state on other tensors copies it into them first.  The
Simulation's ``torch.Generator`` is registered with every graph of a
cadence that draws, so each replay draws fresh variates.

Launch counts: the kernel wrappers count a launch when Python issues it,
so a capture's counts are taken back and added again at every replay.  A
launch under an IF node counts only when its branch ran: each body adds one
to a device tally, and :func:`settle` reads the tallies (one read for
every graphed step that replayed a branch since the last settle) and adds
those launches.  Read the counters after ``settle()``.

Stages: while a step is captured, its stage marker
(``utils.profile.marks``) is ``_Capture.stage``, which lists the nodes each
stage added to the graph (``csrc/graph_cond.cu``'s graph_capture_nodes;
inside an IF body they go to the body's map).  Each graph keeps that stage
map, plain data (``utils.profile.Run`` and ``If``), and adds nothing to the
graph for it.  While a profiler records, and only then, every replay's map
goes to ``replay_log`` and the host ranges ``vpic.chunk`` (a ``run``),
``vpic.replay/<cadence>`` (a replay) and ``vpic.settle`` name what the
host did; ``utils.profile.attribute`` lays the log over the device
records.  ``rebucket_log`` keeps the residency rebuckets by cause over the
same stretch of replays (``ops.residency.rebuckets_by_cause``, read on the
host with no work on the device).

A deck :func:`refusal` names runs the eager step, chosen from its features
when the step is made, never as a fallback: a failed capture, replay or IF
node, or a PyTorch that cannot route the IF bodies' allocations to their
pool, raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
import weakref
from typing import Optional

import torch

from .ops import _build
from .ops import compact as C
from .ops import field_fuse as FF
from .ops import fused_push as FP
from .ops import fused_push3d as FP3
from .ops import move_p as MP
from .ops import residency as RES
from .ops import rho_p as RHO
from .ops import ta_collide as TA
from .state import FIELD_NAMES, SPECIES_NAMES, SimState
from .utils import profile as P

KERNEL = "graph_cond"

# Condition kernels (csrc/graph_cond.cu's set_condition_kernel) launched
# since the count was last reset: one per IF node a replay runs, counted
# as the kernel wrappers' launches are.
launches = 0

# the host counters a step bumps: the kernel wrappers' launch counts and the
# residency relayouts (Simulation.relayouts, the last entry)
COUNTERS = ((FP, "launches"), (FP3, "launches"), (RES, "launches"),
            (RES, "plan_launches"), (FF, "launches"), (MP, "launches"), (C, "launches"),
            (C, "copy_launches"), (C, "mailbox_launches"), (TA, "launches"),
            (RHO, "launches"), (sys.modules[__name__], "launches"))
# the push and charge kernels' device deposit counts, written by the
# captured launches
DEPOSITS = (FP, FP3, RHO)
BRANCHES = ("rebucket", "merge")
HOOKS = ("user_field_injection", "user_current_injection",
         "user_particle_injection", "user_particle_collisions")

# graphed steps with branch launches not yet settled
_unsettled: "weakref.WeakSet[GraphedStep]" = weakref.WeakSet()
# bytes of a kernel's name that graph_capture_nodes keeps
NAME_LEN = 256


class ReplayLog:
    """The stage maps of the replays made under a profiler, one a replay in
    replay order (``utils.profile.attribute`` reads them): those of the
    latest profiled stretch, since a profiled replay that follows an
    unprofiled one starts the log anew, as does one after ``clear()``
    (two profiler sessions with no unprofiled replay between them share
    a log unless it is cleared between them)."""

    def __init__(self):
        self.maps: list = []
        self.fresh = True       # the next profiled replay starts anew

    def add(self, stage_map: tuple):
        if self.fresh:
            self.maps = []
            self.fresh = False
            rebucket_log.begin()
        self.maps.append(stage_map)

    def end(self):
        """The profiled stretch is over: the next profiled replay starts
        the log anew."""
        if not self.fresh:
            rebucket_log.end()
        self.fresh = True

    def clear(self):
        self.maps = []
        self.fresh = True
        rebucket_log.clear()


class RebucketLog:
    """The residency rebuckets by cause (``ops.residency.CAUSES``) of the
    stretch of profiled replays ``replay_log`` holds: the counts as the
    stretch began (its first replay) and as it ended (the next unprofiled
    run), each read on the host from the plans' counters with no work on
    the device, so exact where the device had finished its work by then
    (as after a profiler's closing synchronize)."""

    def __init__(self):
        self.clear()

    def begin(self):
        self._first = RES.rebuckets_by_cause()
        self._last = None

    def end(self):
        if self._first is not None and self._last is None:
            self._last = RES.rebuckets_by_cause()

    def clear(self):
        self._first = self._last = None

    def counts(self) -> Optional[dict]:
        """{cause: rebuckets} over the stretch (up to now where it has
        not ended), or None before a profiled replay."""
        if self._first is None:
            return None
        last = self._last if self._last is not None else \
            RES.rebuckets_by_cause()
        return {k: last[k] - self._first[k] for k in RES.CAUSES}


replay_log = ReplayLog()
rebucket_log = RebucketLog()


def refusal(sim) -> Optional[str]:
    """Why the deck's step runs eagerly, every reason "; "-joined, or None
    when it is captured.  Chosen from the deck's features: a CPU device, a
    decomposed grid (its exchanges are host round trips), a hook that
    takes the host step (a graph would freeze its value), and a collision
    op that is not one of ``collision``'s (its firing test, a function of
    the host step, is not known).  The general path's step makes no
    synchronizing operation on the card (chip_smoke.py phase 29 checks it)
    and is captured."""
    g = sim.grid
    why = []
    if sim.device.type != "cuda":
        why.append(f"device {sim.device.type}: CUDA graphs need the card")
    if g is not None and (g.sharded or g.face_partners is not None):
        why.append("decomposed grid: its exchanges and migration counts "
                   "are host round trips")
    for name in HOOKS:
        if getattr(sim, name) is not None:
            why.append(f"{name} takes the host step")
    for k, op in enumerate(sim.collision_ops):
        if not hasattr(op, "interval"):
            why.append(f"collision op {k} has no interval: its firing "
                       "is not known")
    return "; ".join(why) or None


def _counts(sim) -> list:
    return [getattr(m, a) for m, a in COUNTERS] + [sim.relayouts]


def _set_counts(sim, values):
    for (m, a), v in zip(COUNTERS, values):
        setattr(m, a, v)
    sim.relayouts = values[-1]


def _add_counts(sim, deltas, times: int = 1):
    if times:
        _set_counts(sim, [v + d * times
                          for v, d in zip(_counts(sim), deltas)])


def _minus(a, b):
    return [x - y for x, y in zip(a, b)]


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.graph_if_begin.argtypes is None:
        lib.graph_if_begin.argtypes = [ctypes.c_void_p] * 3
        lib.graph_if_begin.restype = ctypes.c_int
        lib.graph_if_end.argtypes = [ctypes.c_void_p]
        lib.graph_if_end.restype = ctypes.c_int
        lib.graph_cond_error_string.argtypes = [ctypes.c_int]
        lib.graph_cond_error_string.restype = ctypes.c_char_p
        lib.graph_capture_nodes.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.graph_capture_nodes.restype = ctypes.c_int
        lib.graph_cond_cu_error_string.argtypes = [ctypes.c_int]
        lib.graph_cond_cu_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.graph_cond_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: {msg} ({rc})")


def _nodes(stream: int, start: int):
    """(nodes, kinds, names) of the graph ``stream`` is capturing into: its
    number of nodes, and from the ``start``-th node on each one's kind
    (utils.profile.Run's letters, 'o' for a node that leaves no record) and
    kernel name (graph_capture_nodes)."""
    lib = _lib()
    count = ctypes.c_size_t(0)
    rc = lib.graph_capture_nodes(stream, start, None, None, NAME_LEN, 0,
                                 ctypes.byref(count))
    k = count.value - start
    if rc == 0 and k > 0:
        kinds = ctypes.create_string_buffer(k)
        names = ctypes.create_string_buffer(k * NAME_LEN)
        rc = lib.graph_capture_nodes(stream, start, kinds, names, NAME_LEN,
                                     k, ctypes.byref(count))
    if rc != 0:
        msg = lib.graph_cond_cu_error_string(rc).decode()
        raise RuntimeError(f"graph_capture_nodes failed: {msg} ({rc})")
    if k <= 0:
        return count.value, "", []
    raw = names.raw
    return count.value, kinds.raw.decode(), [
        raw[j * NAME_LEN:(j + 1) * NAME_LEN].split(b"\0", 1)[0].decode(
            errors="replace") for j in range(k)]


class _Capture:
    """What the step sees as ``advance.capture`` while it is captured:
    ``stage(name)`` ends the stage that runs and starts ``name`` (None ends
    the last), putting the nodes the stage added into ``stages``, the
    graph's stage map; ``branch(pred, name)`` captures its block under an
    IF node on the 0-d bool ``pred`` (from the owner's body stream,
    allocating from its body pool), maps the block's nodes as the node's
    body and records the block's counter deltas."""

    def __init__(self, owner, tally):
        self.owner, self.tally = owner, tally
        self.deltas = {}
        self.stages = []
        self._stage = None
        self._stream = None     # the capture stream
        self._listed = 0        # nodes of the main graph already mapped
        self._in_body = False

    def stage(self, name: Optional[str]):
        if self._in_body:
            raise RuntimeError(f"stage {name!r} starts inside an IF body")
        self._close()
        self._stage = name

    def _close(self):
        """The nodes added since the last listing, as a Run of the stage
        that runs."""
        if self._stream is None:
            self._stream = torch.cuda.current_stream().cuda_stream
        self._listed, kinds, names = _nodes(self._stream, self._listed)
        run = P.run_of(self._stage, kinds, names)
        if run is None:
            return
        if self._stage is None:
            raise RuntimeError("graph nodes captured outside any stage")
        self.stages.append(run)

    @contextlib.contextmanager
    def branch(self, pred: torch.Tensor, name: str):
        global launches
        owner = self.owner
        dev = pred.device
        if pred.dtype != torch.bool or pred.numel() != 1 or \
                not pred.is_contiguous():
            raise ValueError("an IF node takes a contiguous 0-d bool tensor")
        lib = _lib()
        body = owner.body_stream
        self._close()
        _raise_on(lib, lib.graph_if_begin(
            torch.cuda.current_stream(dev).cuda_stream, body.cuda_stream,
            pred.data_ptr()), "graph_if_begin")
        launches += 1
        # the condition kernel
        self._close()
        before = _counts(owner.sim)
        _to_pool(dev.index, owner.body_pool)
        owner.pool_refs[0] += 1
        self._in_body = True
        try:
            with torch.cuda.stream(body):
                yield
                self.tally.narrow(0, BRANCHES.index(name), 1).add_(1)
            _, kinds, names = _nodes(body.cuda_stream, 0)
        finally:
            self._in_body = False
            torch._C._cuda_endAllocateToPool(dev.index, owner.body_pool)
            _raise_on(lib, lib.graph_if_end(body.cuda_stream),
                      "graph_if_end")
        run = P.run_of(self._stage, kinds, names)
        self.stages.append(P.If(self._stage, name,
                                () if run is None else (run,)))
        self.deltas[name] = _minus(_counts(owner.sim), before)


class _Graph:
    """One captured cadence: the graph, the counter deltas of a replay
    outside the IF nodes and inside each, the device tally of the branches
    taken, the replays not yet settled, the deposit counters the launches
    write, the step's host diag entries, the stage map (_Capture.stage),
    the cadence's ``label`` ("plain", or its decisions "+"-joined) and
    ``replayed``, the map a replay logs (``utils.profile.replayed``: the
    generator's prologue first, in the stage ``drew``, where the step drew
    random numbers)."""

    def __init__(self, graph, deltas, branch_deltas, tally, deposits,
                 host_diag, stages, label, drew=None):
        self.graph = graph
        self.stages = stages
        self.replayed = P.replayed(stages, drew)
        self.label = label
        self.branch_deltas = branch_deltas
        self.deltas = deltas
        for d in branch_deltas.values():
            self.deltas = _minus(self.deltas, d)
        self.tally = tally if branch_deltas else None
        self.unsettled = 0
        self.deposits = deposits
        self.host_diag = host_diag

    def replay(self):
        for mod, t in self.deposits.items():
            # the count since the module's attribute was last set to None
            # goes on in the captured tensor
            cur = mod.deposits
            if cur is not t:
                if cur is None:
                    t.zero_()
                else:
                    t.copy_(cur)
                mod.deposits = t
        self.graph.replay()


class GraphedStep:
    """The deck's step as CUDA graph replays; ``step(state)`` is one step,
    ``step.run(state, n)`` n steps.  ``path`` and ``fields`` are the eager
    step's, ``graphed`` is True; ``graphs`` maps each captured Cadence to
    its graph, ``captures`` counts them, ``eager_steps`` the warm-up
    steps run eagerly and ``taken`` the IF branches replays ran (as of
    the last settle)."""

    graphed = True

    def __init__(self, sim, advance):
        self.sim = sim
        self.advance = advance
        self.path, self.fields = advance.path, advance.fields
        dev = sim.device
        self.pool = torch.cuda.graph_pool_handle()
        # the IF bodies' stream and pool; the pool's references are
        # released with the graphs
        self.body_stream = torch.cuda.Stream(dev)
        self.body_pool = torch.cuda.graph_pool_handle()
        self.pool_refs = [0]
        self.state: Optional[SimState] = None
        # cadence -> the stage that first drew random numbers in its warm-up
        # step (None: it drew none)
        self.warm = {}
        self.graphs = {}
        self.captures = 0
        self.eager_steps = 0
        self.taken = dict.fromkeys(BRANCHES, 0)
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        weakref.finalize(self, _release, self.graphs, index, self.body_pool,
                         self.pool_refs)

    def __call__(self, state: SimState) -> SimState:
        return self.run(state, 1)

    def run(self, state: SimState, n: int) -> SimState:
        """n steps from ``state``: replays, with the warm-up and capture of
        each cadence met for the first and second time.  Under a profiler
        a ``vpic.chunk`` range, each replay's map logged (replay_log)."""
        traced = P.profiling()
        if not traced:
            replay_log.end()
        with P.host_range("vpic.chunk", traced):
            state = self._adopt(state)
            for _ in range(n):
                state = self._step(state, traced)
        return state

    # the graphs' tensors

    def _adopt(self, state: SimState) -> SimState:
        """``state`` in the graphs' tensors: the first state a step gets
        becomes them; a later one on other tensors is copied into them (a
        device copy, no read)."""
        if self.state is None:
            self.state = state
            return state
        own = self.state
        if state.fields is own.fields and all(
                a is b for a, b in zip(state.species, own.species)) and \
                all(state.diag.get(k) is v for k, v in own.diag.items()
                    if isinstance(v, torch.Tensor)):
            return state
        if len(state.species) != len(own.species) or \
                state.diag.keys() != own.diag.keys():
            raise ValueError("the state is not one of this deck's")
        for n in FIELD_NAMES:
            getattr(own.fields, n).copy_(getattr(state.fields, n))
        for a, b in zip(own.species, state.species):
            for n in SPECIES_NAMES:
                getattr(a, n).copy_(getattr(b, n))
        diag = dict(state.diag)
        for k, v in own.diag.items():
            if isinstance(v, torch.Tensor):
                diag[k] = v.copy_(state.diag[k])
        return SimState(fields=own.fields, species=own.species,
                        step=state.step, diag=diag, rng=state.rng)

    def _check_kept(self, state: SimState, out: SimState, what: str):
        ok = out.fields is state.fields and all(
            a is b for a, b in zip(out.species, state.species)) and \
            out.diag.keys() == state.diag.keys() and all(
                out.diag[k] is v for k, v in state.diag.items()
                if isinstance(v, torch.Tensor))
        if not ok:
            raise RuntimeError(f"{what}: the step did not keep the state's "
                               "tensors, so it cannot be replayed")

    # one step

    def _step(self, state: SimState, traced: bool) -> SimState:
        cad = self.advance.cadence(state.step, state.diag)
        entry = self.graphs.get(cad)
        if entry is None:
            if cad not in self.warm:
                return self._warm_up(state, cad)
            entry = self._capture(state, cad)
        if traced:
            replay_log.add(entry.replayed)
            with P.host_range("vpic.replay/" + entry.label, True):
                entry.replay()
        else:
            entry.replay()
        _add_counts(self.sim, entry.deltas)
        if entry.tally is not None:
            entry.unsettled += 1
            _unsettled.add(self)
        diag = dict(state.diag)
        diag.update(entry.host_diag)
        return SimState(fields=state.fields, species=state.species,
                        step=state.step + 1, diag=diag, rng=state.rng)

    def _warm_up(self, state: SimState, cad) -> SimState:
        gen = self.sim._generator
        drew = []
        if gen is not None:
            seen = [gen.get_state(), None]

            def observe(stage):
                # the stage that ends here drew if the generator moved
                now = gen.get_state()
                if not drew and not torch.equal(now, seen[0]):
                    drew.append(seen[1])
                seen[0], seen[1] = now, stage

            self.advance.observe = observe
        try:
            out = self.advance(state)
        finally:
            self.advance.observe = None
        self._check_kept(state, out, "warm-up")
        self.warm[cad] = drew[0] if drew else None
        self.eager_steps += 1
        return out

    def _capture(self, state: SimState, cad) -> _Graph:
        dev = state.fields.ex.device
        for mod in DEPOSITS:
            if mod.deposits is None or mod.deposits.device != dev:
                mod.deposits = torch.zeros(2, dtype=torch.int64, device=dev)
        deposits = {mod: mod.deposits for mod in DEPOSITS}
        tally = torch.zeros(len(BRANCHES), dtype=torch.int64, device=dev)
        graph = torch.cuda.CUDAGraph()
        if self.warm[cad] is not None:
            graph.register_generator_state(self.sim._generator)
        cap = _Capture(self, tally)
        before = _counts(self.sim)
        self.advance.capture = cap
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = self.advance(state)
                cap.stage(None)
        finally:
            self.advance.capture = None
            after = _counts(self.sim)
            # nothing ran: the replays count
            _set_counts(self.sim, before)
        self._check_kept(state, out, "capture")
        entry = _Graph(graph, _minus(after, before), cap.deltas, tally,
                       deposits, {k: v for k, v in out.diag.items()
                                  if not isinstance(v, torch.Tensor)},
                       tuple(cap.stages), label(cad), self.warm[cad])
        self.graphs[cad] = entry
        self.captures += 1
        return entry

    def settle(self):
        """Adds the launches of the IF branches taken since the last
        settle (one device read; a ``vpic.settle`` range under a
        profiler)."""
        todo = [e for e in self.graphs.values() if e.unsettled]
        if not todo:
            return
        with P.host_range("vpic.settle", P.profiling()):
            taken = torch.stack([e.tally for e in todo]).tolist()
            for e, (r, m) in zip(todo, taken):
                if r + m != e.unsettled:
                    raise RuntimeError(f"{e.unsettled} replays took {r} "
                                       f"rebuckets and {m} merges")
                _add_counts(self.sim, e.branch_deltas["rebucket"], r)
                _add_counts(self.sim, e.branch_deltas["merge"], m)
                self.taken["rebucket"] += r
                self.taken["merge"] += m
                e.tally.zero_()
                e.unsettled = 0


def label(cad) -> str:
    """A cadence's decisions that hold, "+"-joined, or "plain"."""
    on = [k for k, v in cad._asdict().items()
          if (any(v) if isinstance(v, tuple) else v)]
    return "+".join(on) or "plain"


def _release(graphs: dict, index: int, pool, refs: list):
    """The graphs first, then the body pool's references."""
    for e in graphs.values():
        e.graph.reset()
    graphs.clear()
    for _ in range(refs[0]):
        torch._C._cuda_releasePool(index, pool)


def _to_pool(index: int, pool):
    """Routes the allocations made until the next endAllocateToPool to
    ``pool`` (each call is a reference on the pool, see _release)."""
    begin = getattr(torch._C, "_cuda_beginAllocateToPool", None)
    if begin is None:
        raise RuntimeError(f"torch {torch.__version__} cannot route "
                           "allocations to a graph pool: the IF bodies "
                           "cannot be captured")
    begin(index, pool)


def settle():
    """Settles every graphed step's branch launches (see GraphedStep.settle):
    call it before reading the launch counters."""
    for gs in list(_unsettled):
        gs.settle()
    _unsettled.clear()


def multi(step, n: int):
    """``n`` steps of ``step`` (a make_step() result) in one call: the
    graphed step's replays (no kernel launched from Python and no device
    read once every cadence of the window is captured), or the eager
    step n times.  Carries the step's ``path``, ``fields`` and
    ``graphed``."""
    if isinstance(step, GraphedStep):
        def many(state: SimState) -> SimState:
            return step.run(state, n)
    else:
        def many(state: SimState) -> SimState:
            for _ in range(n):
                state = step(state)
            return state
    many.path, many.fields, many.graphed = step.path, step.fields, \
        step.graphed
    many.step = step
    return many
