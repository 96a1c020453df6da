"""``field_advance_ms_per_step``: device milliseconds a step in the step's
``field_advance`` stage: the field advance (``field_beb`` or the plain trio).  From the program's stage maps laid over the
traced window's device records (``benchmark/stages.py``); the energies and
restores between repeats left out."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "field_advance")
