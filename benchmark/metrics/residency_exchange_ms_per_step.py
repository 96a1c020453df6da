"""``residency_exchange_ms_per_step``: device milliseconds a step in the step's
``residency_exchange`` stage: the two IF graph nodes with their condition kernels and the body that ran, the rebucket or the merge.  From the program's stage maps laid over the
traced window's device records (``benchmark/stages.py``); the energies and
restores between repeats left out."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "residency_exchange")
