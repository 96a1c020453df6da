"""The decomposed stochastic decks on the card (chip_smoke.py phase 28 at a
small size), two ranks on one card through parallel.mesh.launch (the
gloo-staged transport): the 3-D push kernel with remote faces against its
plain version on the lanes of a collision firing of the reconnection deck,
the 2-D one on the emission diode's, child_langmuir card against CPU from
the same draws (move_p's aged walk against its plain walk) on (1, 2, 1)
where new lanes park at the seams, move_p on received lanes
(scripts/sharded_checks.py's checks and tolerances), the runtime-injection
hook's lanes equal to one domain's on the card, and the dry run's cases.
Every test here is marked ``gpu`` and skips without a CUDA device
(decided inside the fixture, never at import).  This file imports neither
jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_sharded_stochastic.py
"""

import pytest
import torch

from vpic_tpu_torch.parallel import mesh as M
from vpic_tpu_torch.scripts import sharded_checks as SC

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def test_reconnection_ranks_push_after_a_firing(cuda, tmp_path):
    params = dict(nx=16, ny=32, nz=16, nppc=16, Lx=8.0, Ly=16.0, Lz=8.0,
                  topology=(1, 2, 1), tau_coll_interval=2)
    res = M.launch(SC.run_rank, 2, "cuda", args=(
        "reconnection", params, 4, "cuda", 0, True), tmpdir=str(tmp_path))
    SC.conserved(res, "reconnection (1, 2, 1)")
    for r in res:
        assert r["path"] == "push3d" and r["launches"]["fused_push3d"] == 4
        assert r["push"]["remote_parked"] > 0
        assert r["collision"]["launches"] > 0


def test_emission_ranks_emitter_and_push(cuda, tmp_path):
    res = M.launch(SC.run_rank, 2, "cuda", args=(
        "emission", dict(topology=(1, 2, 1), ut_perp=0.5), 12, "cuda", 1,
        True, 0, (1,)), tmpdir=str(tmp_path))
    assert res[0]["marks"][1][0] > 0 and res[0]["dropped"] == 0
    for r in res:
        assert r["path"] == "push2d" and r["launches"]["fused_push2d"] == 11
        assert r["launches"]["move_p"] >= 11 and r["emitter"]["new"] > 0


def test_injection_ranks_match_one_domain(cuda, tmp_path):
    one = SC.inject_rank("cuda", 3, (1, 1, 1), 16, 1024)
    res = M.launch(SC.inject_rank, 2, "cuda", args=(
        "cuda", 3, (1, 2, 1), 16, 1024), tmpdir=str(tmp_path))
    cmp = SC.compare_injected(one["first"], [r["first"] for r in res],
                              (1, 2, 1), 16, 0.02)
    assert cmp["lanes"] == 1024
    assert res[0]["total"] == one["total"] == 3 * 1024


def test_dryrun_on_one_card(cuda, capsys):
    M.dryrun(4, "cuda")
    out = capsys.readouterr().out
    assert "sharded-emitter ok" in out and "sharded-collisional" in out
