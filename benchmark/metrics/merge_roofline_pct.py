"""``merge_roofline_pct``: the residency merge (``csrc/merge_p.cu``) against
the merge's own work a step: each lane that left its brick of
``BRICK``^3 cells is read once and written once into its new brick (8
words each way), and the slot it left is marked dead (one byte).  The
lanes that stay are the merge's to leave where they are, so they are
not counted.

The leavers a step are counted here from the voxels of each checked
step's lanes before it and after the reference's push of them
(``Run.moves``; the reference keeps the lanes' order, the program does
not), the mean over the checked steps, since the program keeps no count.
None without checked steps or without a merge in the trace."""

from benchmark import roofline
from benchmark.reference import pic

KERNELS = ("merge_kernel",)
BRICK = 8


def bytes_per_step(leavers: float) -> float:
    return leavers * (8 * 4 * 2 + 1)


def leavers(pre, post, g: pic.Geom, brick: int = BRICK) -> int:
    """Lanes whose ``brick``^3 block of cells changed over a step, from
    each species' voxels before and after it, in one lane order."""
    n = 0
    for a, b in zip(pre, post):
        ca = [(c - 1) // brick for c in pic.decode(a.long(), g)]
        cb = [(c - 1) // brick for c in pic.decode(b.long(), g)]
        moved = (ca[0] != cb[0]) | (ca[1] != cb[1]) | (ca[2] != cb[2])
        n += int(moved.sum())
    return n


def read(run):
    if not run.moves:
        return None
    n = [leavers(pre, post, run.geom) for pre, post in run.moves]
    return roofline.share(run, KERNELS, bytes_per_step(sum(n) / len(n)),
                          0.0)
