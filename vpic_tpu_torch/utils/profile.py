"""Step-phase wall-clock profiling (counterpart of
``vpic_tpu/utils/profile.py``, src/util/profile/).

The reference brackets every step-loop phase with TIC/TOC around a fixed
timer enum (profile.h:11-63) and prints interval + cumulative tables at
status_interval.  Two tools:

* ``Profile``: host-side named timers (TIC/TOC) for coarse phases (step,
  diagnostics, dumps, checkpoint) -- the table printer is format-compatible
  with update_profile's output.  The step launches work on the card
  without waiting for it: synchronize inside a timed phase to time the
  device's work rather than its launches.
* ``trace``: a torch.profiler profile written as a Chrome trace for
  per-kernel analysis (the modern equivalent of the fixed timer table for
  device code).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict


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


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler profile of the block, the card's kernels
    included where there is one: ``with profile.trace('traces') as prof:``
    yields the profiler (``prof.key_averages()``) and writes
    ``logdir/trace.json`` (Chrome trace format) when the block ends."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
