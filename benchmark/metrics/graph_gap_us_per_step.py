"""``graph_gap_us_per_step``: device idle inside the replays, microseconds
a step: between each claimed replay's first and last device record, the
time no record of it covers (such as the wait after each IF node's
condition kernel).  From the program's stage maps laid over the traced
window (``benchmark/stages.py``)."""

from benchmark import stages


def read(run):
    got = stages.attribution(run)
    if got is None:
        return None
    return got.graph_gap_us / run.timeline.steps
