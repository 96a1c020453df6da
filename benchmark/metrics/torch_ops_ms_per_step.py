"""``torch_ops_ms_per_step``: device milliseconds a step in everything that
is not one of the port's hand-written kernels: the plain-torch ops of the
step (the cleaners' deposit and stencils, the interpolator load, the
accumulator unload, sorts, the residency plan, elementwise kernels),
copies and fills.  The energies and restores between repeats are left
out (``trace.BETWEEN``).

The hand kernels are those the metric files name (``core.hand_kernels``:
each roofline's ``KERNELS``, and ``OTHER_HAND`` here for those no
roofline times), so a hand kernel that comes with its roofline file is
not counted here."""

from benchmark import core

OTHER_HAND = ("set_condition_kernel", "move_p_kernel", "compact_kernel",
              "block_copy_kernel", "mailbox_kernel")


def read(run):
    tl = run.timeline
    if tl is None or tl.steps <= 0 or not tl.device:
        return None
    hand = core.hand_kernels()
    rest = sum(e - s for n, s, e in tl.step_device()
               if not any(h in n for h in hand))
    return rest / 1e3 / tl.steps
