"""Step-phase profiling (counterpart of ``vpic_tpu/utils/profile.py``,
src/util/profile/).

The reference brackets every step-loop phase with TIC/TOC around a fixed
timer enum (profile.h:11-63) and prints interval + cumulative tables at
status_interval.  Here:

* ``Profile``: host-side named timers (TIC/TOC) for coarse phases (step,
  diagnostics, dumps, checkpoint) -- the table printer is format-compatible
  with update_profile's output.  The step launches work on the card
  without waiting for it: synchronize inside a timed phase to time the
  device's work rather than its launches (``Simulation.run`` does).
* ``trace``: a torch.profiler profile written as a Chrome trace for
  per-kernel analysis (the modern equivalent of the fixed timer table for
  device code), with the step's stages as a track of their own.
* the step's stages (``STAGES``, VPIC's advance.cc phases where it names
  one): ``marks`` is the marker the step (``Simulation.make_advance``)
  calls as each stage starts.  Eagerly under a profiler it opens a
  ``vpic.<stage>`` record_function range; while the step is captured as a
  CUDA graph it writes the graph's stage map (``Run``, ``If``;
  ``step_graph._Capture.stage``), since a replay runs no Python.  The
  graphed step logs the map of every replay made under a profiler
  (``step_graph.replay_log``; ``replayed`` puts the records PyTorch issues
  before the launch of a graph that draws random numbers in front of
  it), and ``attribute`` lays those maps over the device records of the
  window, which gives each stage its device time inside the graphs.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

PREFIX = "vpic."
# the step's stages in the step's order (make_advance); on the 2-D and
# residency paths a deck's collision ops run before the sort
STAGES = ("load_interpolator", "sort_p", "collision", "advance_p",
          "residency_plan", "residency_exchange", "unload_accumulator",
          "field_advance", "clean_div", "carry")
# the port's hand-written kernels (csrc/), by the identifier each kernel's
# name holds, mangled or not
HAND_KERNELS = ("fused_push2d_kernel", "fused_push3d_kernel", "merge_kernel",
                "field_beb", "set_condition_kernel", "move_p_kernel",
                "compact_kernel", "block_copy_kernel", "mailbox_kernel")
# the device records of copies and fills
COPIES = ("Memcpy", "Memset")
# The device records PyTorch's CUDAGraph.replay makes before it launches a
# graph whose capture drew from a registered generator: two int64 fills,
# the generator's seed and offset for the replay (CUDAGeneratorState::
# replay_prologue, PyTorch 2.3 and later).
GENERATOR_PROLOGUE = "kk"

Record = Tuple[str, float, float]


class Profile:
    def __init__(self):
        self._interval = OrderedDict()
        self._total = OrderedDict()
        self._counts = OrderedDict()

    @contextlib.contextmanager
    def tic(self, name: str, n: int = 1):
        """TIC {...} TOC(name, n) (profile.h:52-63)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._interval[name] = self._interval.get(name, 0.0) + dt
            self._total[name] = self._total.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + n

    def update_profile(self, dump: bool = True) -> str:
        """Print the interval + cumulative table and reset the interval
        counters (update_profile analogue)."""
        lines = [f"{'phase':<28} {'interval(s)':>12} {'total(s)':>12} "
                 f"{'count':>8}"]
        for name, tot in self._total.items():
            lines.append(f"{name:<28} {self._interval.get(name, 0.0):12.4f} "
                         f"{tot:12.4f} {self._counts[name]:8d}")
        self._interval.clear()
        table = "\n".join(lines)
        if dump:
            print(table)
        return table


# the step's stages

def profiling() -> bool:
    """Whether a torch.profiler session is recording."""
    return torch._C._autograd._profiler_enabled()


def host_range(name: str, on: bool):
    """A record_function range named ``name`` where ``on``, else nothing."""
    if on:
        return torch.autograd.profiler.record_function(name)
    return contextlib.nullcontext()


def _no_mark(stage: Optional[str]):
    pass


def marks(capture=None, observe=None):
    """The stage marker of one step: ``mark(stage)`` ends the stage that
    runs and starts ``stage``; ``mark(None)`` ends the last.  While the
    step is captured (``capture``: step_graph's _Capture) it is
    ``capture.stage``, which writes the graph's stage map; eagerly under a
    profiler it closes and opens ``vpic.<stage>`` record_function ranges;
    else it does nothing (the profiler is asked once, here).  Eagerly,
    ``observe(stage)`` is called too at every mark."""
    if capture is not None:
        return capture.stage
    if not profiling():
        return observe or _no_mark
    rng = [None]

    def mark(stage: Optional[str]):
        if rng[0] is not None:
            rng[0].__exit__(None, None, None)
            rng[0] = None
        if stage is not None:
            rng[0] = torch.autograd.profiler.record_function(PREFIX + stage)
            rng[0].__enter__()
        if observe is not None:
            observe(stage)

    return mark


class Run(NamedTuple):
    """A stretch of one stage's graph nodes that leave a device record:
    ``kinds`` one letter a node in replay order (k a kernel, c a memcpy, s
    a memset) and ``anchors`` the stretch's hand-written kernels as
    (offset, identifier in HAND_KERNELS)."""
    stage: str
    kinds: str
    anchors: Tuple[Tuple[int, str], ...]


class If(NamedTuple):
    """A conditional (IF) node of ``stage``: ``body`` (a map of Runs) runs
    right after the condition kernel before it in the map when the node's
    condition holds; ``branch`` names it."""
    stage: str
    branch: str
    body: tuple


def hand_of(name: str) -> Optional[str]:
    """The HAND_KERNELS identifier a kernel's name holds, or None."""
    for h in HAND_KERNELS:
        if h in name:
            return h
    return None


def run_of(stage: str, kinds: str, names: Sequence[str]) -> Optional[Run]:
    """The Run of ``stage`` over listed graph nodes (kinds as in Run, 'o'
    for a node that leaves no record, which is left out), or None when none
    leaves a record."""
    kept = [(c, n) for c, n in zip(kinds, names) if c != "o"]
    if not kept:
        return None
    return Run(stage, "".join(c for c, _ in kept),
               tuple((j, h) for j, (c, n) in enumerate(kept)
                     if c == "k" and (h := hand_of(n)) is not None))


def replayed(stage_map, drew: Optional[str]) -> tuple:
    """The map of a replay of a graph whose capture map is ``stage_map``:
    where the graph draws random numbers, ``drew`` names the stage that
    drew first, and the generator's prologue (``GENERATOR_PROLOGUE``) comes
    first, in that stage; else the capture map."""
    if drew is None:
        return tuple(stage_map)
    return (Run(drew, GENERATOR_PROLOGUE, ()),) + tuple(stage_map)


def records(stage_map) -> int:
    """The device records of a map with every IF body counted."""
    return sum(len(it.kinds) if isinstance(it, Run) else records(it.body)
               for it in stage_map)


@dataclass
class Attribution:
    """What ``attribute`` found in a window: ``spans`` (stage, start, end),
    one a stage and replay; ``stage_us`` each stage's device time (the sum
    of its records); ``unstaged`` the records no replay claimed;
    ``graph_gap_us`` the idle inside the claimed replays (between each
    one's first and last record); ``launch_gap_us`` the idle between
    consecutive claimed replays; ``replays`` claimed and ``misfits`` not;
    ``taken`` the IF bodies found, by branch; ``stage_replays`` the claimed
    replays that ran each stage (a record of it).  Times in the records'
    unit (microseconds)."""
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    stage_us: Dict[str, float] = field(default_factory=dict)
    unstaged: List[Record] = field(default_factory=list)
    graph_gap_us: float = 0.0
    launch_gap_us: float = 0.0
    replays: int = 0
    misfits: int = 0
    taken: Dict[str, int] = field(default_factory=dict)
    stage_replays: Dict[str, int] = field(default_factory=dict)


class _Window:
    """The records' names reduced to what a map predicts: each record's
    hand kernel (or None) and whether it is a copy or fill."""

    def __init__(self, recs: Sequence[Record]):
        self.recs = recs
        self.hand = [hand_of(r[0]) for r in recs]
        self.copy = [r[0].startswith(COPIES) for r in recs]
        self._expect = {}

    def matches(self, run: Run, i: int) -> bool:
        """Whether the records from i on are ``run``'s: its anchors where
        it has them, no hand kernel elsewhere, and no copy or fill where it
        has a kernel (a memcpy node may run as a kernel)."""
        n = len(run.kinds)
        if i + n > len(self.recs):
            return False
        exp = self._expect.get(id(run))
        if exp is None:
            hands = [None] * n
            for j, h in run.anchors:
                hands[j] = h
            exp = (hands, [j for j, c in enumerate(run.kinds) if c == "k"])
            self._expect[id(run)] = exp
        hands, kernels = exp
        return self.hand[i:i + n] == hands and \
            not any(self.copy[i + j] for j in kernels)

    def walk(self, items: tuple, i: int, k: int = 0):
        """The records from i on that the map ``items[k:]`` accounts for:
        (end, [(stage, first, end)], [branches taken]) or None.  At an IF
        node both ways are tried, the body skipped first: a wrong guess
        breaks at the next anchor or copy."""
        runs = []
        while k < len(items):
            it = items[k]
            if isinstance(it, Run):
                if not self.matches(it, i):
                    return None
                runs.append((it.stage, i, i + len(it.kinds)))
                i += len(it.kinds)
                k += 1
                continue
            rest = self.walk(items, i, k + 1)
            if rest is not None:
                return rest[0], runs + rest[1], rest[2]
            body = self.walk(it.body, i)
            if body is None:
                return None
            rest = self.walk(items, body[0], k + 1)
            if rest is None:
                return None
            return rest[0], runs + body[1] + rest[1], \
                body[2] + [it.branch] + rest[2]
        return i, runs, []


def _lead(stage_map) -> Optional[Tuple[int, str]]:
    """(records before it, identifier) of the map's first anchor, where no
    IF node comes before it."""
    off = 0
    for it in stage_map:
        if not isinstance(it, Run):
            return None
        if it.anchors:
            j, h = it.anchors[0]
            return off + j, h
        off += len(it.kinds)
    return None


def _resync(w: _Window, log, r: int, i: int, first: bool):
    """After replay r did not fit at record i: the (replay, record, fit)
    of the next few replays (r itself too where no replay has fitted yet)
    whose map fits from the earliest record, found at its first anchor.
    The earliest: a map can also fit a later replay's tail (a plain step's
    over a firing step's records), so the first replay to fit is not
    always the next to run."""
    longest = max(records(m) for m in log[r:r + 4])
    best = None
    for r2 in range(r if first else r + 1, min(r + 4, len(log))):
        lead = _lead(log[r2])
        if lead is None:
            continue
        off, h = lead
        stop = min(len(w.recs), i + 4 * (r2 - r + 1) * longest)
        if best is not None:
            stop = min(stop, best[1] + off + 1)
        for q in range(i, stop):
            p = q - off
            if w.hand[q] != h or p < i or (r2 == r and p == i):
                continue
            got = w.walk(log[r2], p)
            if got is not None:
                if best is None or p < best[1]:
                    best = (r2, p, got)
                break
    return best


def attribute(recs: Sequence[Record], log: Sequence[tuple],
              cuts: Sequence[Tuple[float, float]] = ()) -> Attribution:
    """Lays the stage maps of ``log`` (one a replay, in replay order:
    ``step_graph.replay_log``) over a window's device records ``recs``
    ((name, start, end), in start order).  Each replay claims the records
    its map predicts from where the last one ended; at each IF node the
    records tell whether its body ran.  A replay whose records do not fit
    (a record the profiler dropped, a wrong anchor) claims none: its
    records stay unstaged, and the walk picks up at the next replay's
    first anchor.  The idle between two consecutive replays counts unless
    unclaimed records lie between them or it overlaps one of ``cuts``
    (intervals of other work, such as the energies between repeats)."""
    w = _Window(recs)
    out = Attribution()
    claimed = [False] * len(recs)
    fits = []           # (replay, first record, end record)
    i = r = 0
    while r < len(log) and i < len(recs):
        got = w.walk(log[r], i)
        if got is None:
            found = _resync(w, log, r, i, first=not fits)
            if found is None:
                r += 1
                out.misfits += 1
                continue
            r2, i, got = found
            out.misfits += r2 - r
            r = r2
        end, runs, taken = got
        fits.append((r, i, end))
        for stage, a, b in runs:
            out.stage_us[stage] = out.stage_us.get(stage, 0.0) + sum(
                e - s for _, s, e in recs[a:b])
            for j in range(a, b):
                claimed[j] = True
            if out.spans and out.spans[-1][0] == stage and a > i:
                out.spans[-1] = (stage, out.spans[-1][1], recs[b - 1][2])
            else:
                out.spans.append((stage, recs[a][1], recs[b - 1][2]))
        for stage in {stage for stage, _, _ in runs}:
            out.stage_replays[stage] = out.stage_replays.get(stage, 0) + 1
        for br in taken:
            out.taken[br] = out.taken.get(br, 0) + 1
        busy = sum(b - a for a, b in _union(recs[i:end]))
        out.graph_gap_us += recs[end - 1][2] - recs[i][1] - busy
        i, r = end, r + 1
    out.misfits += len(log) - r
    out.replays = len(fits)
    out.unstaged = [rec for rec, c in zip(recs, claimed) if not c]
    for (ra, _, ea), (rb, fb, _) in zip(fits, fits[1:]):
        if rb != ra + 1 or fb != ea:
            continue
        a, b = recs[ea - 1][2], recs[fb][1]
        if b > a and not any(x < b and a < y for x, y in cuts):
            out.launch_gap_us += b - a
    return out


def _union(recs: Sequence[Record]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, a, b in sorted(recs, key=lambda s: s[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


# the operator's trace

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGE_TID = "vpic stages"


def stage_track(events: List[dict], log) -> List[dict]:
    """Chrome-trace events of the stages' device spans: ``log`` laid over
    the device records among ``events`` (a Chrome trace's traceEvents), on
    a track of their own beside the first record's."""
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                  and e.get("ph") == "X"), key=lambda e: e["ts"])
    if not dev or not log:
        return []
    got = attribute([(e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                     for e in dev], log)
    pid = dev[0]["pid"]
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": STAGE_TID,
            "args": {"name": STAGE_TID}}]
    for stage, a, b in got.spans:
        out.append({"ph": "X", "cat": "vpic_stage", "name": stage,
                    "pid": pid, "tid": STAGE_TID, "ts": a, "dur": b - a})
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler profile of the block, the card's kernels
    included where there is one: ``with profile.trace('traces') as prof:``
    yields the profiler (``prof.key_averages()``) and writes
    ``logdir/trace.json`` (Chrome trace format) when the block ends, with
    the device spans of the graphed step's stages (the replays' maps laid
    over the kernels, ``stage_track``) on a track named "vpic stages"."""
    from .. import step_graph
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    step_graph.replay_log.clear()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    track = stage_track(doc.get("traceEvents", []), step_graph.replay_log.maps)
    if track:
        doc["traceEvents"].extend(track)
        with open(path, "w") as fh:
            json.dump(doc, fh)
