"""``field_roofline_pct``: the field advance (``csrc/field_beb.cu``: B a
half step, E a step, B a half step) against its own work a step: per
interior cell, E, cB, the curl accumulators and the currents read once
(12 words) and E, cB and the curl accumulators written once (9 words);
69 float32 operations a cell (two half B steps 36, the E step 33; the bytes bound)."""

from benchmark import roofline

KERNELS = ("field_beb",)
FLOPS_PER_CELL = 69


def bytes_per_step(cells: int) -> float:
    return cells * (12 + 9) * 4


def read(run):
    return roofline.share(run, KERNELS, bytes_per_step(run.cells),
                          FLOPS_PER_CELL * run.cells)
