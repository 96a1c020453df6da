"""Tiny configurations of the benchmark's cells for the CPU tests: the
cell's own files with the grid, the particles a cell and the run length
cut so that a run takes seconds on the CPU."""

from benchmark import core

TINY = {
    "harris3d.32cube.128ppc": dict(nx=8, ny=8, nz=8, nppc=8.0, Lx=8.0,
                                   Ly=8.0, Lz=8.0, taui=20.0),
    "harris2d.64sq.64ppc": dict(nx=16, ny=16, nppc=16.0, Lx=8.0, Ly=8.0,
                                taui=20.0),
}
SEED = 2 ** 31 + 77


def tiny(cell: str) -> core.Spec:
    sp = core.spec(cell)
    sp.config["params"].update(TINY[cell])
    return sp
