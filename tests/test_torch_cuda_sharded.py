"""A rank's remote faces on the card: both push kernels' WALLS instance
parks a lane that reaches a face another rank owns with pend = face, and
move_p walks received lanes on, each against its plain version
(vpic_tpu_torch/scripts/sharded_checks.py's checks: PERF.md §2 row 3's
WALLS tolerances); and a small decomposed run through
parallel.mesh.launch, two ranks on one card (the gloo-staged transport).
Every test here is marked ``gpu`` and skips without a CUDA device
(decided inside the fixture, never at import).  This file imports neither
jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_sharded.py
"""

import pytest
import torch

import vpic_tpu_torch.grid as G
import vpic_tpu_torch.ops.fused_push as FP
import vpic_tpu_torch.ops.fused_push3d as FP3
from vpic_tpu_torch.parallel import mesh as M
from vpic_tpu_torch.scripts import sharded_checks as SC

pytestmark = pytest.mark.gpu

HARRIS_2D = dict(nx=32, ny=32, nppc=16, Lx=16.0, Ly=16.0)
N = 1 << 16


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _grid(topology, n, xbc=G.REFLECT_PARTICLES):
    """A brick of a decomposed grid with reflecting (or absorbing) x walls
    and periodic y and z (remote where the axis is decomposed)."""
    g = G.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0, *n, *topology,
                                 dt=0.4, cvac=1.0, eps0=1.0)
    return g.with_bc(0, pbc=xbc).with_bc(3, pbc=xbc)


@pytest.mark.parametrize("topology,rank", (((1, 2, 1), 0), ((2, 2, 1), 1),
                                           ((2, 2, 1), 2)))
def test_push2d_remote_faces_match_plain(cuda, topology, rank):
    g = _grid(topology, (64, 64, 1))
    with M.use(M.Mesh(rank, g.n_shards, "cuda", "local")):
        sps, fcoef, qms = SC.random_lanes(g, N, cuda, seed=rank)
        sps = [FP.bucket_sort_p(sp, g) for sp in sps]
        res = SC.compare_walls(FP.fused_push_multi, FP.fused_push_multi_ref,
                               g, sps, fcoef, qms)
    assert res["remote_parked"] > 0


@pytest.mark.parametrize("homes", (True, False))
def test_push3d_remote_faces_match_plain(cuda, homes):
    g = _grid((1, 2, 2), (16, 32, 32), G.ABSORB_PARTICLES)
    with M.use(M.Mesh(3, 4, "cuda", "local")):
        sps, fcoef, qms = SC.random_lanes(g, N, cuda, seed=3)
        kw = {}
        if homes:
            srt = [FP3.brick_sort_p_home(sp, g) for sp in sps]
            sps, kw["homes"] = [s[0] for s in srt], [s[1] for s in srt]
        res = SC.compare_walls(FP3.fused_push3d_multi,
                               FP3.fused_push3d_multi_ref, g, sps, fcoef,
                               qms, **kw)
    assert res["remote_parked"] > 0


@pytest.mark.parametrize("topology", ((1, 2, 1), (2, 1, 1)))
def test_move_p_received_lanes_match_plain(cuda, topology):
    g = _grid(topology, (32, 32, 1))
    with M.use(M.Mesh(0, 2, "cuda", "local")):
        sps, _, qms = SC.random_lanes(g, N, cuda, n_species=1)
        res = SC.compare_move(sps[0], g, qms[0][0])
    assert res["walked"] > 0 and res["left_again"] > 0


def test_decomposed_harris_on_one_card(cuda, tmp_path):
    """Two ranks on the card: the 2-D WALLS push once a step per rank,
    move_p on the arrivals, every particle kept, drift < 1e-3."""
    res = M.launch(SC.run_rank, 2, "cuda", args=(
        "harris", dict(HARRIS_2D, topology=(1, 2, 1)), 20, "cuda", 0, True),
        tmpdir=str(tmp_path))
    SC.conserved(res, "harris (1, 2, 1)")
    transport = "nccl" if torch.cuda.device_count() >= 2 else "gloo-staged"
    for r in res:
        assert r["transport"] == transport
        assert r["launches"][FP.KERNEL] == 20
        assert r["drift"] < 1e-3
        assert r["push"]["remote_parked"] > 0
