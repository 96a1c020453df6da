"""``overflow_rebuckets_per_step``: the residency step's rebuckets in the
traced window whose plan overflowed, a block's outbox (leavers past its
cap) or the exchange (a brick's inflow past its blocks' free slots, or
more rows routed than the compact bound), over the window's steps.  The
rest of the rebuckets come from misplaced lanes alone.  Read from the
program's log of rebuckets by cause over its profiled replays
(``vpic_tpu_torch.step_graph.rebucket_log``, the plans' counters read on
the host); None on a program without that log."""


def read(run):
    tl = run.timeline
    if tl is None or tl.steps <= 0:
        return None
    try:
        from vpic_tpu_torch import step_graph
        got = step_graph.rebucket_log.counts()
    except (ImportError, AttributeError):
        return None
    if got is None:
        return None
    return (got["outbox"] + got["exchange"]) / tl.steps
