"""``launch_gap_us_per_step``: device idle between consecutive replays,
microseconds a step: from one claimed replay's last record to the next
one's first, where nothing else ran between them (the energies and
restores between repeats are not crossed).  From the program's stage maps
laid over the traced window (``benchmark/stages.py``)."""

from benchmark import stages


def read(run):
    got = stages.attribution(run)
    if got is None:
        return None
    return got.launch_gap_us / run.timeline.steps
