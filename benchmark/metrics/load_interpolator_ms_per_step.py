"""``load_interpolator_ms_per_step``: device milliseconds a step in the step's
``load_interpolator`` stage: the interpolator load (``ops/interp.load_interpolator``).  From the program's stage maps laid over the
traced window's device records (``benchmark/stages.py``); the energies and
restores between repeats left out."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "load_interpolator")
