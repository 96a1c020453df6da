"""The stochastic operators on the card against the CPU, at a small size
(chip_smoke.py phases 18-21 run them at full size): each collision op and
child_langmuir from CPU-made draws, aged injection at initialize(), the
collisional reconnection deck's residency step (the 3-D push once a step, a
rebucket before the push on every firing step, merges on the others, one
host read a step, the species storage kept) and the emission diode's step
(the 2-D WALLS push once a step, move_p once per emitter call, no
synchronizing operation).  Every test here is marked ``gpu`` and skips
without a CUDA device (decided inside the fixture, never at import).  This
file imports neither jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_stochastic.py

Tolerances: those of vpic_tpu_torch/scripts/stochastic_checks.py (the
shuffle permutation, live masks, voxels and weights equal; momenta 1e-5
max|u|; new lanes atol 3e-5, rhob and acc 1e-5 of their largest; aged lanes
atol 2e-6)."""

import warnings

import pytest
import torch

import vpic_tpu_torch as vt
import vpic_tpu_torch.ops.fused_push as FP
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.move_p as MP
import vpic_tpu_torch.ops.residency as RES
from vpic_tpu_torch import step_graph as SG
from vpic_tpu_torch.models import emission, reconnection
from vpic_tpu_torch.scripts import stochastic_checks as SC

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["hard_sphere", "takizuka_abe",
                                  "takizuka_abe_inter",
                                  "large_angle_coulomb", "langevin"])
def test_collision_op_card_matches_cpu(cuda, name):
    g = SC.collision_grid(8)
    n = 1 << 14
    host = [SC.collision_species(n, g, seed=0),
            SC.collision_species(n, g, seed=1)]
    SC.compare_collision_op(SC.collision_ops(g, n)[name], host, g, cuda)


def test_collision_op_makes_no_sync(cuda):
    g = SC.collision_grid(8)
    n = 1 << 14
    sp = SC.to([SC.collision_species(n, g, seed=0),
                SC.collision_species(n, g, seed=1)], cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    op = SC.collision_ops(g, n)["takizuka_abe_inter"]
    op(sp, None, g, 0, gen, {})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        op(sp, None, g, 0, gen, {})
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_child_langmuir_card_matches_cpu(cuda):
    sim = emission.build(emission.EmissionParams(nx=16, ny=4, Lx=0.5,
                                                 Ly=0.125), device="cpu")
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(12):
        state = step(state)
    MP.launches = 0
    _, new = SC.compare_child_langmuir(sim, state, cuda)
    assert new > 0 and MP.launches == 1


def test_aged_initialize_card_matches_cpu(cuda):
    MP.launches = 0
    _, killed = SC.compare_aged_initialize(vt, cuda, 600)
    assert killed > 0 and MP.launches == 1


def test_reconnection_residency_step_on_card(cuda):
    p = reconnection.ReconnectionParams(nx=16, ny=16, nz=16, nppc=8,
                                        Lx=8.0, Ly=8.0, Lz=8.0, headroom=6.0,
                                        tau_coll_interval=3)
    sim = reconnection.build(p)
    assert sim._residency_mode()[0]
    state = sim.initialize()
    n0 = [int(sp.np) for sp in state.species]
    ptrs = [sp.dx.data_ptr() for sp in state.species]
    step = sim.make_step()
    FP3.launches = RES.launches = 0
    sim.host_syncs = sim.relayouts = 0
    for _ in range(7):
        state = step(state)
    # the merges under the graphed steps' IF nodes count once settled;
    # only the eager warm-up steps read the decision on the host
    SG.settle()
    post = int(state.diag["_res_rebuckets"])
    assert FP3.launches == 7 and sim.relayouts == 3
    assert RES.launches == 7 - post
    assert sim.host_syncs == step.eager_steps == 3
    assert [sp.dx.data_ptr() for sp in state.species] == ptrs
    assert [int(sp.np) for sp in state.species] == n0
    assert int(state.diag["unfinished"]) == 0


def test_emission_step_on_card(cuda):
    sim = emission.build(emission.EmissionParams(nx=16, ny=4, Lx=0.5,
                                                 Ly=0.125))
    state = sim.initialize()
    step = sim.make_step()
    FP.launches = MP.launches = 0
    for _ in range(30):
        state = step(state)
    assert FP.launches == 30 and MP.launches == 30
    key = [k for k in state.diag if k.startswith("absorb_tally/")][0]
    assert int(state.diag[key]) > 0 and int(state.species[0].np) > 0
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(2):
                state = step(state)
        finally:
            torch.cuda.set_sync_debug_mode("default")
