"""``clean_div_ms_per_step``: device milliseconds a step in the step's
``clean_div`` stage: the cleaners on their cadence: ``clean_e``, ``clean_b`` and ``synchronize_tang_e_norm_b``.  From the program's stage maps laid over the
traced window's device records (``benchmark/stages.py``); the energies and
restores between repeats left out."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "clean_div")
