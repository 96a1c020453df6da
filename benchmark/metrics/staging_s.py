"""``staging_s``: seconds of the deck's build, the host staging of its particle load (`models/harris.build`: the per-particle `inject_particle` loop), on the host clock."""


def read(run):
    return run.times.get("staging_s")
