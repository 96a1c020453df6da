"""``advance_p_ms_per_step``: device milliseconds a step in the step's
``advance_p`` stage: the accumulator's zeroing, the push kernel with its wrapper's torch ops, the parked lanes' handlers and the emitters.  From the program's stage maps laid over the
traced window's device records (``benchmark/stages.py``); the energies and
restores between repeats left out."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "advance_p")
