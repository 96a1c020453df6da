"""``residency_plan_ms_per_step``: device milliseconds a step in the step's
``residency_plan`` stage: the residency plan: ``block_counts``, ``plan_exchange``, ``any_misplaced`` and the rebuild bool.  From the program's stage maps laid over the
traced window's device records (``benchmark/stages.py``); the energies and
restores between repeats left out."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "residency_plan")
