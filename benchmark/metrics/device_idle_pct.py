"""``device_idle_pct``: the share of the traced window in which no device
activity ran, from the union of the activities' intervals (overlapping
kernels count their common time once)."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_us <= 0 or not tl.device:
        return None
    return 100.0 * (1.0 - tl.busy_us() / tl.window_us)
