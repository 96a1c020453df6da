"""``general_sort_roofline_pct``: the general path's relayout
(``ops/push.sort_p``, a stable sort of every species by voxel on its
``sort_interval``) against its own work a firing, over the device time of
the step's ``sort_p`` stage (``benchmark/stages.py``).

The work of one firing, every species sorted (as every species of the
benchmark's general-path deck is, on one cadence): each live lane's key
read once (its voxel, 1 word) and its 8 lane words (offsets, voxel,
momenta, weight) read once and written once, 17 words a lane; the dead
slots the sort also moves are the implementation's, as ``roofline.py``
counts live lanes only.  Bytes bound it.  The firings are the claimed
replays whose map ran the stage (``Attribution.stage_replays``): None
without a traced firing, or on a program whose attribution does not
count them."""

from benchmark import peaks, stages

WORDS_PER_LANE = 1 + 8 + 8


def bytes_per_firing(lanes) -> float:
    return 4.0 * WORDS_PER_LANE * sum(lanes)


def read(run):
    got = stages.attribution(run)
    peak = peaks.lookup(run.device_kind)
    firings = getattr(got, "stage_replays", {}).get("sort_p", 0)
    us = got.stage_us.get("sort_p", 0.0) if got is not None else 0.0
    if peak is None or firings <= 0 or us <= 0:
        return None
    bound_s = firings * bytes_per_firing(run.lanes) / peak.bytes_per_s
    return 100.0 * bound_s / (us * 1e-6)
