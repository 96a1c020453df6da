"""``kernels_per_step``: device kernels (copies and fills left out) in the
traced window over the steps it ran, the energies and restores between
repeats left out (``trace.BETWEEN``).  Fewer kernels a step means fewer
gaps between graph nodes."""


def read(run):
    tl = run.timeline
    if tl is None or tl.steps <= 0:
        return None
    return len(tl.kernels()) / tl.steps
