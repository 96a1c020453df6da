"""``initialize_s``: seconds of `Simulation.initialize()`: packing the staged lanes, the field fixups and the first interpolator, on the host clock around a synchronize."""


def read(run):
    return run.times.get("initialize_s")
