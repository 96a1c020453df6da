"""``push_roofline_pct``: the push kernels (``csrc/fused_push2d.cu``,
``csrc/fused_push3d.cu``) against the push's own work a step.

Bytes: each live lane read once (offsets, voxel, momenta, weight: 8
words) and written once (offsets, voxel, momenta: 7 words); each interior
voxel's interpolator row read once (18 words) and its accumulator row
written once (12 words).  Operations: ``FLOPS_PER_LANE`` float32
operations a lane that crosses no face (interpolation 27, Boris rotation
with both half kicks 61, the displacement 13, one streak round with its
current deposit 68); the bytes bound."""

from benchmark import roofline

KERNELS = ("fused_push2d_kernel", "fused_push3d_kernel")
FLOPS_PER_LANE = 169


def bytes_per_step(lanes: int, cells: int) -> float:
    return lanes * (8 + 7) * 4 + cells * (18 + 12) * 4


def read(run):
    lanes, cells = sum(run.lanes), run.cells
    return roofline.share(run, KERNELS, bytes_per_step(lanes, cells),
                          FLOPS_PER_LANE * lanes)
