"""``grid_roofline_pct``: the grid layers ``ops/interp.load_interpolator``
and ``unload_accumulator`` against their own work a step, over the device
time of the step's ``load_interpolator`` and ``unload_accumulator``
stages (``benchmark/stages.py``), so that it reads the same work
whatever kernels later do them.

Per interior voxel and step: the interpolator load reads E and cB once
(6 words) and writes its 18-word row once; the unload reads the voxel's
12 accumulator words once and writes its 3 edge currents once (the
stage's zeroing of jf and its shared-face fold are the unload's to fold
in).  39 words, 156 bytes a voxel; a few tens of float32 operations a
voxel, so the bytes bound it.  None without a traced window or where the
program's stage maps claim neither stage."""

from benchmark import peaks, stages

STAGES = ("load_interpolator", "unload_accumulator")
WORDS_PER_CELL = 6 + 18 + 12 + 3


def bytes_per_step(cells: int) -> float:
    return 4.0 * WORDS_PER_CELL * cells


def read(run):
    peak = peaks.lookup(run.device_kind)
    ms = [stages.stage_ms(run, s) for s in STAGES]
    if peak is None or any(m is None for m in ms) or sum(ms) <= 0:
        return None
    bound_s = bytes_per_step(run.cells) / peak.bytes_per_s
    return 100.0 * bound_s / (sum(ms) * 1e-3)
