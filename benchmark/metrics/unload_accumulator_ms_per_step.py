"""``unload_accumulator_ms_per_step``: device milliseconds a step in the step's
``unload_accumulator`` stage: ``clear_jf``, the accumulator unload, ``synchronize_jf`` and the current hook.  From the program's stage maps laid over the
traced window's device records (``benchmark/stages.py``); the energies and
restores between repeats left out."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "unload_accumulator")
