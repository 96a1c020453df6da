"""``general_push_roofline_pct``: the 3-D push kernel on the deck's general
path (``csrc/fused_push3d.cu`` without home maps: no deposit tile in
shared memory, every current deposit a global atomic) against the push's
own work a step, counted as ``push_roofline_pct`` counts it: its
``bytes_per_step`` and ``FLOPS_PER_LANE``, imported so that the count has
one source.  The work is the same whatever implements it, so a later
shared-memory deposit on this path is judged on the same count.

This entry exists beside ``push_roofline_pct`` only because that
metric's ``workloads`` list was not extended to the general-path cell;
a change to the benchmark may merge the two."""

from benchmark import roofline
from benchmark.metrics.push_roofline_pct import FLOPS_PER_LANE, bytes_per_step

KERNELS = ("fused_push3d_kernel",)


def read(run):
    lanes, cells = sum(run.lanes), run.cells
    return roofline.share(run, KERNELS, bytes_per_step(lanes, cells),
                          FLOPS_PER_LANE * lanes)
