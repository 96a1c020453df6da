"""``rebuckets_per_repeat``: the residency step's rebuckets (the brick sort
an IF graph node runs in place of the merge when a lane cannot be merged)
over the repeats of the window, from the program's counter
``diag["_res_rebuckets"]`` (a device tensor the IF body bumps: no
``step_graph.settle()`` is needed for it), copied before each restore.
The first step's relayout of each repeat is not one of them.  None on a
deck without residency."""


def read(run):
    return run.rebuckets_per_repeat
