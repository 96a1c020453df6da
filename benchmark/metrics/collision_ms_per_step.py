"""``collision_ms_per_step``: device milliseconds a step in the step's
``collision`` stage: the deck's collision ops (their draws, the per-cell
shuffle sorts, the partitions, the pair arithmetic and the scatters),
over every step of the window, firing or not.  From the program's stage
maps laid over the traced window's device records
(``benchmark/stages.py``); the energies and restores between repeats
left out."""

from benchmark import stages


def read(run):
    return stages.stage_ms(run, "collision")
