"""``sort_p_ms_per_step``: device milliseconds a step in the step's
``sort_p`` stage: the sorts: the 2-D bucket sort, the 3-D relayout or brick sort, the general path's sort_p.  From the program's stage maps laid over the
traced window's device records (``benchmark/stages.py``); the energies and
restores between repeats left out."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "sort_p")
