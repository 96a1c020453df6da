"""``collision_roofline_pct``: the ``collision`` stage against its own work,
over the stage's device time (``benchmark/stages.py``), so that it reads
the same work whatever kernels later do the ops.

The work of one firing of the collisional reconnection deck's three
Takizuka-Abe ops (``OPS``: ion-ion, electron-electron, electron-ion, as
species index pairs), each op counted alone: each live lane of each
species the op touches read once (voxel, momenta, weight: 5 words), its
momenta written once (3 words) and its shuffle key read once (1 word);
each pair's 4 variates (4 words).  A pair within a species is two lanes,
one between species an i-lane.  Bytes bound it: the pair arithmetic is
~200 float32 operations a pair.  The firings are the claimed replays whose
map ran the stage (``Attribution.stage_replays``): None on a program whose
attribution does not count them, or without a traced firing."""

from benchmark import peaks, stages

OPS = ((0, 0), (1, 1), (1, 0))
LANE_WORDS = 5 + 3 + 1
PAIR_WORDS = 4


def bytes_per_firing(lanes) -> float:
    words = 0
    for i, j in OPS:
        if i == j:
            words += lanes[i] * LANE_WORDS + lanes[i] // 2 * PAIR_WORDS
        else:
            words += (lanes[i] + lanes[j]) * LANE_WORDS + \
                lanes[i] * PAIR_WORDS
    return 4.0 * words


def read(run):
    got = stages.attribution(run)
    peak = peaks.lookup(run.device_kind)
    firings = getattr(got, "stage_replays", {}).get("collision", 0)
    us = got.stage_us.get("collision", 0.0) if got is not None else 0.0
    if peak is None or firings <= 0 or us <= 0 or len(run.lanes) < 2:
        return None
    bound_s = firings * bytes_per_firing(run.lanes) / peak.bytes_per_s
    return 100.0 * bound_s / (us * 1e-6)
