"""A stage's share of its roofline: the least time the card could take for
the stage's own work (bytes over peak bandwidth or float32 operations
over peak rate, whichever is larger) over the device time of the kernels
that do it, from the traced window.  The work is counted from what the
stage reads and writes, each input byte once and each output byte once,
live lanes only, whatever the implementation moves besides."""

from __future__ import annotations

from typing import Optional, Sequence

from . import peaks


def share(run, kernels: Sequence[str], bytes_per_step: float,
          flops_per_step: float) -> Optional[float]:
    """Percent of the roofline, or None where the trace holds none of
    ``kernels`` or the card's peaks are not known."""
    peak = peaks.lookup(run.device_kind)
    tl = run.timeline
    if peak is None or tl is None or tl.steps <= 0:
        return None
    t = tl.time_us(kernels) * 1e-6 / tl.steps
    if t <= 0:
        return None
    bound = max(bytes_per_step / peak.bytes_per_s,
                flops_per_step / peak.fp32_flops_per_s)
    return 100.0 * bound / t
