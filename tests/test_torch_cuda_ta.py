"""The Takizuka-Abe op's hand kernels (csrc/ta_collide.cu, run by the op's
apply on CUDA tensors) against the plain op (``op.apply_plain``) on the
card, from the same draws: the order pass's permutation and voxel
partition bit for bit against shuffle_sort and cell_partition, the
shuffled slots' live masks, voxels, weights and offsets bit for bit, the
momenta to 1e-5 max|u| (tests/test_torch_collision.py's bound); a firing
captured in a CUDA graph equals the eager one; the kernels build for
sm_90a and spill nothing; on the card only the T&A ops take the "cuda"
route.  Every test here is marked
``gpu`` and skips without a CUDA device (decided inside the fixture, never
at import).  This file imports neither jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_ta.py
"""

import pytest
import torch

from vpic_tpu_torch.models import reconnection
from vpic_tpu_torch.ops import _build
from vpic_tpu_torch.ops import ta_collide as TA
from vpic_tpu_torch.scripts import stochastic_checks as SC

pytestmark = pytest.mark.gpu

N = 1 << 14


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def test_kernels_build_for_sm_90a_without_spills(cuda):
    _build.build_many([TA.KERNEL])
    log = _build.build_log(TA.KERNEL)
    spills = [ln for ln in log.splitlines() if "spill stores" in ln]
    assert "sm_90a" in log and spills
    assert all("0 bytes spill stores" in ln for ln in spills), spills


@pytest.mark.parametrize("name, route", [
    ("takizuka_abe", "cuda"), ("takizuka_abe_inter", "cuda"),
    ("hard_sphere", "plain"), ("large_angle_coulomb", "plain")])
def test_route_on_the_card(cuda, name, route):
    g = SC.collision_grid(4)
    host = [SC.collision_species(512, g, seed=0),
            SC.collision_species(512, g, seed=1)]
    op = SC.collision_ops(g, 512)[name]
    sp = SC.to(host, cuda)
    op.apply(sp, g, op.draw(torch.Generator(device=cuda).manual_seed(0), sp))
    assert op.route == route


def _kill(sp, dead):
    return sp.replace(live=sp.live & ~dead, w=torch.where(dead, 0.0, sp.w))


def _case(case, g):
    """(species a, b on the CPU, the lanes whose keys lose their top bits).
    The inter op pairs i = b with j = a."""
    n = N + 3 if case == "odd" else N
    a = SC.collision_species(N // 3 if case == "ni_gt_nj" else n, g, seed=0)
    b = SC.collision_species(n, g, seed=1)
    crowd = None
    if case == "holes":
        a = _kill(a, (torch.arange(a.capacity) % 7 == 3)
                  | (torch.arange(a.capacity) // 1000 == 5))
        b = _kill(b, torch.arange(b.capacity) % 5 == 1)
    elif case == "nj_zero":
        a = _kill(a, a.i % 3 == 0)
    elif case == "over_cap":
        # 3000 lanes of each species in one voxel, their keys' top bits
        # cleared so that they share one segment past the cap
        crowd = torch.arange(n) < 3000
        a = a.replace(i=torch.where(crowd, a.i[0], a.i))
        b = b.replace(i=torch.where(crowd, a.i[0], b.i))
    return a, b, crowd


@pytest.mark.parametrize("case", ["full", "holes", "ni_gt_nj", "nj_zero",
                                  "odd", "over_cap"])
@pytest.mark.parametrize("name", ["takizuka_abe", "takizuka_abe_inter"])
def test_hand_matches_plain(cuda, case, name):
    g = SC.collision_grid(8)
    a, b, crowd = _case(case, g)
    host = [a, b]
    op = SC.collision_ops(g, N)[name]
    draws = op.draw(torch.Generator().manual_seed(7), host)
    if crowd is not None:
        for k in ("shuf_i", "shuf_j"):
            if k in draws[0]:
                draws[0][k] = torch.where(crowd, draws[0][k] >> 8,
                                          draws[0][k])
    i, j = op.pair
    passes = [(host[i], draws[0]["shuf_i"])]
    if i != j:
        passes.append((host[j], draws[0]["shuf_j"]))
    want = [sum(x) for x in zip(*(TA.wide_ref(sp.live, sp.i, key, g.nv)
                                  for sp, key in passes))]
    on_card = SC.to(host, cuda)
    d = SC.to(draws, cuda)
    for sp, key in passes:
        SC.compare_order(SC.to(sp, cuda), key.to(cuda), g)
    torch.cuda.synchronize()
    before = TA.wide_lanes()
    SC.compare_routes(op, on_card, g, d)
    torch.cuda.synchronize()
    after = TA.wide_lanes()
    assert [after[k] - before[k] for k in ("live", "dead")] == want
    if case == "over_cap":
        assert want[0] >= 3000 * len(passes)


def test_reconnection_state_after_a_firing(cuda):
    """The three ops of the collisional reconnection deck at 32^3 x 128 ppc
    on its state after step 0 (a firing), op after op, each from the plain
    op's output of the one before."""
    sim = reconnection.build(reconnection.ReconnectionParams(
        nx=32, ny=32, nz=32, nppc=128))
    state = sim.initialize()
    state = sim.make_step()(state)
    species, g = list(state.species), sim.grid
    gen = torch.Generator(device=cuda).manual_seed(11)
    torch.cuda.synchronize()
    before = TA.wide_lanes()
    want = [0, 0]
    for op in sim.collision_ops:
        draws = op.draw(gen, species)
        for k, sp in zip(("shuf_i", "shuf_j"), op.pair):
            if k in draws[0]:
                key = draws[0][k]
                SC.compare_order(species[sp], key, g)
                w = TA.wide_ref(species[sp].live, species[sp].i, key, g.nv)
                want = [x + 2 * y for x, y in zip(want, w)]
        SC.compare_routes(op, species, g, draws)
        species = op.apply_plain(species, g, draws)[0]
    torch.cuda.synchronize()
    after = TA.wide_lanes()
    assert [after[k] - before[k] for k in ("live", "dead")] == want


@pytest.mark.parametrize("name", ["takizuka_abe", "takizuka_abe_inter"])
def test_captured_firing_equals_eager(cuda, name):
    g = SC.collision_grid(8)
    host = [SC.collision_species(N, g, seed=0),
            SC.collision_species(N, g, seed=1)]
    op = SC.collision_ops(g, N)[name]
    sp = SC.to(host, cuda)
    draws = SC.to(op.draw(torch.Generator().manual_seed(3), host), cuda)
    eager = op.apply(sp, g, draws)[0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op.apply(sp, g, draws)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = op.apply(sp, g, draws)[0]
    graph.replay()
    torch.cuda.synchronize()
    assert op.route == "cuda"
    for a, b in zip(eager, out):
        for n in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live"):
            assert torch.equal(getattr(a, n), getattr(b, n)), n
