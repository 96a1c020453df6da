"""The push timers' CPU-side logic (``utils/push_timing.py``): the
``Pusher`` that every timed push goes through, which must give each push the
same input lanes and a zeroed accumulator.  The timers themselves need a
CUDA card."""

import numpy as np
import torch

import vpic_tpu_torch.grid as G
import vpic_tpu_torch.ops.fused_push as FP
from vpic_tpu_torch.state import SpeciesState
from vpic_tpu_torch.utils import push_timing as PT


def _same_bits(x, y):
    if x.dtype == torch.float32:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))
    return torch.equal(x, y)


def _lanes(g, n, seed):
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt)
    x = rng.integers(1, g.nx + 1, n)
    y = rng.integers(1, g.ny + 1, n)
    live = rng.random(n) < 0.9
    return SpeciesState(
        dx=t(rng.uniform(-1, 1, n)), dy=t(rng.uniform(-1, 1, n)),
        dz=t(rng.uniform(-1, 1, n)), i=t(x + g.NX * (y + g.NY), torch.int32),
        ux=t(rng.normal(0, 2, n)), uy=t(rng.normal(0, 2, n)),
        uz=t(rng.normal(0, 2, n)), w=t(rng.uniform(0.5, 1.5, n)),
        live=t(live, torch.bool), np=t(live.sum(), torch.int32))


def test_pusher_gives_every_push_the_same_inputs():
    """Two pushes through one Pusher (on the CPU: the plain version) leave
    the same lanes and accumulator as one push of a clone, and the input
    lanes untouched."""
    g = G.partition_periodic_box(0, 0, 0, 1.0, 1.0, 0.25, 8, 8, 1,
                                 cvac=1.0, eps0=1.0)
    g = G.Grid(**{**g.__dict__, "dt": 0.9 * g.courant_length()})
    fcoef = torch.tensor(np.random.default_rng(3).normal(0, 0.3, (g.nv, 18)),
                         dtype=torch.float32)
    species = [_lanes(g, 500, seed) for seed in (1, 2)]
    before = PT.clone_species(species)
    qms = [(-1.0, 1.0), (1.0, 25.0)]
    acc = torch.zeros((g.nv, 12))
    want, acc, _ = FP.fused_push_multi(PT.clone_species(species), fcoef, acc,
                                       g, qms)
    p = PT.Pusher(FP.fused_push_multi, g, species, fcoef, qms)
    for _ in range(2):
        p.fresh()
        got = p.push()[0]
        assert torch.equal(p.acc, acc)
        for a, b in zip(got, want):
            for n in PT.MOVED:
                assert _same_bits(getattr(a, n), getattr(b, n)), n
    for a, b in zip(species, before):
        for n in PT.LANES:
            assert torch.equal(getattr(a, n), getattr(b, n))
