"""The traced window's device records by stage of the program's step.

The program's graphed step logs the stage map of every replay made under
a profiler (``vpic_tpu_torch.step_graph.replay_log``: the nodes each stage
of the step added to the graph when it was captured), and its
``utils.profile.attribute`` lays those maps over the steps' device records
(``Timeline.step_device``: the energies and restores between repeats left
out).  The idle between two replays that a ``BETWEEN`` range's device span
separates is not counted.  A program that keeps no such log, or a run
without a timeline, gives None: the stage metrics are then left out of
the result line.  The attribution is made once a run."""

from benchmark import trace


def attribution(run):
    """The program's ``Attribution`` of the run's traced window, or None."""
    tl = run.timeline
    if tl is None or tl.steps <= 0:
        return None
    if getattr(run, "_stages", None) is not None:
        return run._stages
    try:
        from vpic_tpu_torch import step_graph
        from vpic_tpu_torch.utils.profile import attribute
        maps = step_graph.replay_log.maps
    except (ImportError, AttributeError):
        return None
    if not maps:
        return None
    cuts = [(a, b) for n, a, b in tl.labels if n in trace.BETWEEN]
    run._stages = attribute(tl.step_device(), maps, cuts)
    return run._stages


def stage_ms(run, stage: str):
    """Device ms a step in the records of ``stage``."""
    got = attribution(run)
    if got is None:
        return None
    return got.stage_us.get(stage, 0.0) / 1e3 / run.timeline.steps
