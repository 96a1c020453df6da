"""The traced window and the arithmetic of its timeline.

``profiled()`` runs torch.profiler (CPU and CUDA activities) over a block,
with the card idle for ``PAD_S`` on each side of the block's work: kineto
keeps only the device activities inside its capture window, converted to
the host's clock, and a burst of launches right at an edge can be dropped
whole.  ``Timeline.from_profiler`` keeps what the readers need: every
device activity (kernels, copies, fills) as ``(name, start, end)`` in
microseconds, the host ranges, the device side of the harness's own
ranges (``bench.*``: the span from the first to the last device activity
launched inside each), and the window, which is the host range named
``WINDOW`` (it ends after the block's closing synchronize).

The per-step readers take the window's device activities less those
inside the device side of a ``BETWEEN`` range: the energies and the
restore that the harness runs between repeats are not the step's work.

The idle share is one minus the union of the device intervals inside the
window over its length: two kernels that overlap count their common time
once.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

PAD_S = 0.005
LABEL_PREFIX = "bench."
WINDOW = LABEL_PREFIX + "window"
STEPS = LABEL_PREFIX + "steps"
# the harness's ranges between repeats, whose device work no step does
BETWEEN = (LABEL_PREFIX + "energies", LABEL_PREFIX + "restore")
COPY_PREFIXES = ("Memcpy", "Memset")
NAME = 120  # characters of a name kept in the breakdown

Span = Tuple[str, float, float]


@contextlib.contextmanager
def profiled():
    """torch.profiler over the block, with the card idle for PAD_S before
    and after the block's (synchronized) work; yields the profiler."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PAD_S)


def warm_profiler():
    """One profiler session over one tiny kernel, for the set-up of a
    deck whose graphs hold conditional (IF) nodes.  Such replays run in
    one of two modes on an H100 (PyTorch 2.11, CUDA 12.8): a slow one,
    ~60 us of idle at each IF node, in which every process starts, and a
    fast one, which every process reaches after 1-40 s of replays and
    never leaves; a profiler session, however short, switches it at
    once.  The window then measures the mode a long run spends its time
    in."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    prof.events()


@dataclass
class Timeline:
    device: List[Span] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)
    steps: int = 0
    labels: List[Span] = field(default_factory=list)

    @classmethod
    def from_profiler(cls, prof, steps: int) -> "Timeline":
        dev, host, labels, win = [], [], [], None
        for e in prof.events():
            span = (e.name, float(e.time_range.start),
                    float(e.time_range.end))
            if e.device_type.name == "CUDA":
                # the host ranges' shadows on the device timeline are not
                # device work; the harness's own are kept apart
                if e.name.startswith(LABEL_PREFIX):
                    labels.append(span)
                elif not getattr(e, "is_user_annotation", False):
                    dev.append(span)
            elif e.name == WINDOW:
                win = span[1:]
            else:
                host.append(span)
        if win is None:
            raise RuntimeError(f"the trace has no {WINDOW!r} range")
        return cls(device=sorted(dev, key=lambda s: s[1]), host=host,
                   window=win, steps=steps, labels=labels)

    # what the readers take

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def step_device(self) -> List[Span]:
        """The device activities of the steps: those inside the window
        that start inside no device span of a ``BETWEEN`` range."""
        skip = [(a, b) for n, a, b in self.labels if n in BETWEEN]
        lo, hi = self.window
        return [s for s in self.device if lo <= s[1] < hi
                and not any(a <= s[1] < b for a, b in skip)]

    def kernels(self) -> List[Span]:
        """The steps' device activities that are kernels (no copy or
        fill)."""
        return [s for s in self.step_device()
                if not s[0].startswith(COPY_PREFIXES)]

    def busy_us(self) -> float:
        """The time inside the window covered by any device activity."""
        return sum(b - a for a, b in merged(self.device, self.window))

    def time_us(self, names) -> float:
        """The steps' device time in the kernels whose name holds any of
        ``names``."""
        return sum(e - s for n, s, e in self.step_device()
                   if any(k in n for k in names))

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals inside the window."""
        out, t = [], self.window[0]
        for a, b in merged(self.device, self.window):
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host range open at ``t`` (the shortest that holds
        it), or "host idle"."""
        best: Optional[Span] = None
        for s in self.host:
            if s[1] <= t < s[2] and (best is None
                                     or s[2] - s[1] < best[2] - best[1]):
                best = s
        return best[0] if best else "host idle"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each gap named by the host range open at its start and the
        device operation before it; seconds."""
        tot = {}
        for n, s, e in self.device:
            if self.window[0] <= s < self.window[1]:
                tot[n] = tot.get(n, 0.0) + (e - s)
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        ends = [(e, n) for n, _, e in self.device]
        ends.sort()
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            before = [n for e, n in ends if e <= a]
            after = before[-1][:NAME // 2] if before else "window start"
            named.append([f"{self.host_at(a)[:NAME // 2]} | after {after}",
                          (b - a) / 1e6])
        return {"device_ops": [[n[:NAME], v / 1e6] for n, v in ops],
                "idle_gaps": named}


def merged(spans, window) -> List[Tuple[float, float]]:
    """The union of the spans' intervals, clipped to ``window``, as
    disjoint sorted intervals."""
    lo, hi = window
    out: List[List[float]] = []
    for _, a, b in sorted(spans, key=lambda s: s[1]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
