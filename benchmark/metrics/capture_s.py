"""``capture_s``: seconds of the warm repeats of the deck's run before the window: the first step of each cadence eager, its graph captured at the second (`step_graph.GraphedStep`), on the host clock around a synchronize."""


def read(run):
    return run.times.get("capture_s")
