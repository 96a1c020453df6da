"""``residency_plan_kernels_ms_per_step``: device milliseconds a step in
the residency plan's hand-written kernels (``csrc/res_plan.cu``: the lane
pass, the route's tile and key passes and the row scatter), from the
traced window, the energies and restores between repeats left out
(``trace.BETWEEN``).  None where the trace holds none of them, as on a
program whose plan is plain torch.  Naming them here keeps them out of
``torch_ops_ms_per_step`` (``core.hand_kernels``)."""

KERNELS = ("res_plan_lanes_kernel", "res_plan_tiles_kernel",
           "res_plan_keys_kernel", "res_plan_scatter_kernel")


def read(run):
    tl = run.timeline
    if tl is None or tl.steps <= 0:
        return None
    t = tl.time_us(KERNELS)
    if t <= 0:
        return None
    return t / 1e3 / tl.steps
