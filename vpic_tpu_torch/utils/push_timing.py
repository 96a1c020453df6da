"""Push timers: each push of every species on a fresh copy of the same
input lanes, timed by CUDA events (``time_push``) or by the kernel's device
time under torch.profiler (``push_device_ms``).  ``chip_smoke.py`` and
``scripts/sharded_checks.py`` use them and ``clone_species``.
"""

from __future__ import annotations

import torch

LANES = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live", "np")
MOVED = LANES[:9]                       # the arrays a push writes (w and
                                        # live where a wall kills a lane)
REPS = 20                               # pushes per timing


def clone_species(species):
    return [sp.replace(**{n: getattr(sp, n).clone() for n in LANES})
            for sp in species]


class Pusher:
    """Pushes every species with ``fn`` on a working copy of the same input
    lanes: ``fresh()`` restores the copy and zeroes the accumulator,
    ``push()`` pushes it."""

    def __init__(self, fn, g, species, fcoef, qms, **kw):
        self.fn, self.g, self.species, self.fcoef, self.qms, self.kw = (
            fn, g, species, fcoef, qms, kw)
        self.work = clone_species(species)
        self.acc = torch.zeros((g.nv, 12), dtype=torch.float32,
                               device=fcoef.device)

    def fresh(self):
        for w, s in zip(self.work, self.species):
            for n in MOVED:
                getattr(w, n).copy_(getattr(s, n))
        self.acc.zero_()

    def push(self):
        return self.fn(self.work, self.fcoef, self.acc, self.g, self.qms,
                       **self.kw)


def time_push(fn, g, species, fcoef, qms, **kw):
    """Mean ms of one push of every species: CUDA events around each of
    REPS pushes after two warm-up pushes, each on a fresh copy of the same
    input lanes (restored outside the events)."""
    p = Pusher(fn, g, species, fcoef, qms, **kw)
    total = 0.0
    for rep in range(REPS + 2):
        p.fresh()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p.push()
        end.record()
        torch.cuda.synchronize()
        if rep >= 2:
            total += start.elapsed_time(end)
    return total / REPS


def push_device_ms(fn, kernel, g, species, fcoef, qms, **kw):
    """Device ms per push of every species in the kernels whose name holds
    ``kernel`` (torch.profiler over REPS pushes), each push on a fresh copy
    of the same input lanes."""
    from ..scripts import kernel_device_ms
    p = Pusher(fn, g, species, fcoef, qms, **kw)

    def push():
        p.fresh()
        p.push()

    return kernel_device_ms(push, kernel, REPS)
