"""``unstaged_ms_per_step``: device milliseconds a step in the records no
replay's stage map claimed (``benchmark/stages.py``): records the profiler
dropped or added break a replay's fit, and its records land here, as does
any step work outside the graphs.  The energies and restores between
repeats are left out."""

from benchmark import stages


def read(run):
    got = stages.attribution(run)
    if got is None:
        return None
    return sum(e - s for _, s, e in got.unstaged) / 1e3 / \
        run.timeline.steps
