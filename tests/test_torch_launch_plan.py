"""The push kernels' launch planning, on the CPU: which CUDA block serves
which lanes (``fused_push.launch_plan``, ``species_groups``), how long a 3-D
block's run of layout blocks is (``fused_push3d.run_length``), and the host
arrays the entry points take (``c_species_table``, ``push_constants``).

The kernels find a CUDA block's species as ``species_of_block`` in
csrc/push_lane.cuh does: the last species whose first block is at or below
it.  ``_served`` mirrors that rule, so the tests hold the plan to what the
kernels read from it."""

import ctypes

import numpy as np
import pytest
import torch

import vpic_tpu_torch.grid as G
import vpic_tpu_torch.ops.fused_push as FP
import vpic_tpu_torch.ops.fused_push3d as FP3
from vpic_tpu_torch.models import harris


def _served(blocks, run):
    """{(species, layout block): CUDA block} of a launch_plan, read as the
    kernels read it; raises on a layout block served twice."""
    blk0, grid = FP.launch_plan(blocks, run)
    served = {}
    for c in range(grid):
        s = 0
        while s + 1 < len(blocks) and c >= blk0[s + 1]:
            s += 1
        first = (c - blk0[s]) * run
        mine = range(first, min(first + run, blocks[s]))
        assert len(mine) > 0, f"CUDA block {c} serves nothing"
        for b in mine:
            assert (s, b) not in served
            served[(s, b)] = c
    return served, grid


@pytest.mark.parametrize("blocks,run", [
    ([128, 128], 1),        # 2-D harris: one CUDA block per 1024 lanes
    ([2304, 2304], 18),     # 3-D harris residency extents on 132 SMs
    ([5, 0, 7, 1], 3),      # an empty species and ragged runs
    ([1], 4),
    ([37] * 9, 5),
])
def test_launch_plan_serves_every_block_once(blocks, run):
    served, grid = _served(blocks, run)
    assert set(served) == {(s, b) for s, nb in enumerate(blocks)
                           for b in range(nb)}
    assert grid == sum(-(-nb // run) for nb in blocks)
    # a run never spans two species, and consecutive blocks share one
    for (s, b), c in served.items():
        assert c == FP.launch_plan(blocks, run)[0][s] + b // run


def test_launch_plan_refuses_empty_runs():
    with pytest.raises(ValueError):
        FP.launch_plan([3], 0)


@pytest.mark.parametrize("nblocks,slots", [(4608, 132), (4608, 264),
                                           (100, 132), (1, 132),
                                           (1000, 7)])
def test_run_length_fills_the_card_in_few_waves(nblocks, slots):
    run = FP3.run_length(nblocks, slots)
    grid = -(-nblocks // run)
    assert run >= 1
    assert grid <= FP3.WAVES * slots
    if run > 1:     # one layout block fewer would need another wave
        assert -(-nblocks // (run - 1)) > FP3.WAVES * slots
    with pytest.raises(ValueError):
        FP3.run_length(nblocks, 0)


def test_run_length_at_the_harris3d_deck():
    """32^3 x 128 ppc residency extents, both species, on 132 SMs of one
    1024-thread block each: runs of 18 layout blocks, half a brick's 36."""
    run = FP3.run_length(2 * 2304, 132)
    assert run == 18
    assert FP.launch_plan([2304, 2304], run)[1] == 256


def _lanes(n, seed):
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.tensor(a, dtype=dt)
    return FP3.SpeciesState(
        dx=t(rng.uniform(-1, 1, n)), dy=t(rng.uniform(-1, 1, n)),
        dz=t(rng.uniform(-1, 1, n)), i=t(rng.integers(0, 99, n), torch.int32),
        ux=t(rng.normal(size=n)), uy=t(rng.normal(size=n)),
        uz=t(rng.normal(size=n)), w=t(np.ones(n)),
        live=t(np.ones(n, bool), torch.bool), np=t(n, torch.int32))


@pytest.mark.parametrize("caps,groups", [
    ([5, 0, 7], [[0, 2]]),
    ([3] * 8, [list(range(8))]),
    ([3] * 9 + [0, 2], [list(range(8)), [8, 10]]),
    ([0], []),
])
def test_species_groups_skip_empty_species(caps, groups):
    species = [_lanes(n, k) for k, n in enumerate(caps)]
    assert FP.species_groups(species) == groups
    assert all(len(gr) <= FP.MAX_SPECIES for gr in groups)


def test_species_table_layout():
    """13 pointers a species in the entry points' order (the wall outputs
    pend and pdisp last), the lane counts and each species' qdt_2mc =
    q dt / (2 m c), qsp = q and qr8v = q r8V as float32."""
    g = harris.build(harris.HarrisParams(nx=16, ny=16, nppc=1, Lx=4.0,
                                         Ly=4.0), device="cpu").grid
    species = [_lanes(5, 0), _lanes(9, 1)]
    qms = [(-1.0, 1.0), (1.0, 25.0)]
    homes = [torch.zeros(1, dtype=torch.int32) for _ in species]
    pends = [torch.zeros(sp.capacity, dtype=torch.int32) for sp in species]
    disps = [torch.zeros((3, sp.capacity)) for sp in species]
    ptrs, n, qdt, qsp, qr8v = FP.c_species_table(species, qms, g,
                                                 homes=homes, pends=pends,
                                                 disps=disps)
    assert len(ptrs) == 26 and list(n) == [5, 9]
    order = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live")
    for k, sp in enumerate(species):
        row = list(ptrs[13 * k: 13 * k + 13])
        assert row[:9] == [getattr(sp, f).data_ptr() for f in order]
        assert row[9] == homes[k].data_ptr() and row[10] is None
        assert row[11:] == [pends[k].data_ptr(), disps[k].data_ptr()]
        q, m = qms[k]
        assert qdt[k] == np.float32((q * g.dt) / (2.0 * m * g.cvac))
        assert qsp[k] == np.float32(q)
        assert qr8v[k] == np.float32(q * g.r8V)
    ptrs = FP.c_species_table(species, qms, g)[0]
    assert all(ptrs[13 * k + j] is None for k in (0, 1)
               for j in (9, 10, 11, 12))
    assert isinstance(ptrs, ctypes.Array)


def test_wall_constants_read_the_particle_faces():
    """The WALLS instance's arguments: each face's own code, the vbc table
    and rhob; none without walls."""
    import vpic_tpu_torch.ops.push as P
    g = G.partition_periodic_box(0, 0, 0, 1, 2, 4, 8, 16, 1)
    assert FP.wall_constants(g, None)[0] == 0
    g = g.with_bc(0, pbc=G.ABSORB_PARTICLES).with_bc(
        4, pbc=G.FIRST_CUSTOM_PBC)
    walls = P.Walls(torch.zeros(g.nv), torch.zeros((g.nv, 6),
                                                   dtype=torch.int32))
    on, bc, vbc, rhob = FP.wall_constants(g, walls)
    assert on == 1 and list(bc) == [G.ABSORB_PARTICLES, 0, 0, 0,
                                    G.FIRST_CUSTOM_PBC, 0]
    assert vbc == walls.vbc.data_ptr() and rhob == walls.rhob.data_ptr()


def test_push_constants_read_the_particle_faces():
    g = G.partition_periodic_box(0, 0, 0, 1, 2, 4, 8, 16, 32)
    g = g.with_bc(0, pbc=G.REFLECT_PARTICLES).with_bc(
        3, pbc=G.REFLECT_PARTICLES)
    c = FP.push_constants(g)
    assert c[3:] == (8, 16, 32, 0, 1, 1)
    assert c[:3] == (g.cvac * g.dt * g.rdx, g.cvac * g.dt * g.rdy,
                     g.cvac * g.dt * g.rdz)


def test_deposit_counter_is_kept_per_device():
    a = FP.deposit_counter(None, torch.device("cpu"))
    assert a.dtype == torch.int64 and a.tolist() == [0, 0]
    assert FP.deposit_counter(a, torch.device("cpu")) is a
    assert FP.deposit_counter(a, torch.device("meta")) is not a
