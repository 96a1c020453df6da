"""The residency step on the interleaved layout (``brick_sort_p_res``), on
the card against the CPU.  Every test here is marked ``gpu`` and skips
without a CUDA device (decided inside the fixture, never at import).  This
file imports neither jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_interleave.py

* One residency step from the same lanes on both devices: the hot 16^3 x 32
  ppc reconnection deck of tests/test_torch_residency_interleave.py after
  its step-0 firing (on the CPU), relaid with brick_sort_p_home and with
  brick_sort_p_res (8 or more blocks a brick), pushed by the card's kernel.
  The card's plan decides as the CPU's plan on the card's pushed lanes: the
  rebuild and its cause (the old layout an outbox overflow, the interleaved
  none); the card's merge or rebucket gives the CPU's lanes as a multiset.
* 10 graphed steps of the benchmark's 32^3 x 128 ppc reconnection deck
  (firings at steps 0 and 5): at most one rebucket, where the old layout
  rebucketed on every step (an outbox overflow each)."""

import numpy as np
import pytest
import torch

import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.interp as I
import vpic_tpu_torch.ops.residency as RES
from vpic_tpu_torch import step_graph as SG
from vpic_tpu_torch.models import reconnection
from vpic_tpu_torch.state import SPECIES_NAMES

pytestmark = pytest.mark.gpu

HOT = dict(nx=16, ny=16, nz=16, nppc=32, Lx=8.0, Ly=8.0, Lz=8.0,
           wpe_wce=1.5, tau_coll_interval=5)
# the benchmark cell reconnection3d.32cube.128ppc.tau5's deck
CELL = dict(nx=32, ny=32, nz=32, nppc=128.0, Lx=16.0, Ly=16.0, Lz=16.0,
            headroom=1.5, tau_coll_interval=5)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _to(sp, dev):
    return sp.replace(**{n: getattr(sp, n).to(dev, copy=True)
                         for n in SPECIES_NAMES})


def _rows(sp):
    """The live lanes' rows, sorted (a multiset)."""
    sp = _to(sp, "cpu")
    cols = torch.stack([sp.i.double()] + [
        getattr(sp, n).double()
        for n in ("dx", "dy", "dz", "ux", "uy", "uz", "w")], 1).numpy()
    rows = cols[sp.live.numpy()]
    return rows[np.lexsort(rows.T[::-1])]


def _fired():
    """The hot deck right after its step-0 firing, on the CPU, on the
    residency extents."""
    sim = reconnection.build(reconnection.ReconnectionParams(**HOT),
                             device="cpu")
    res_on, slack = sim._residency_mode()
    assert res_on
    state = sim.initialize()
    g = sim.grid
    gen = torch.Generator().manual_seed(1)
    species = list(state.species)
    for op in sim.collision_ops:
        species = op(species, state.fields, g, 0, gen)
    n0 = sim._live_bounds()
    species = [RES.slice_species(sp, E)
               for sp, E in zip(species, RES.extents(g, n0, slack))]
    qms = [(st.params.q, st.params.m) for st in sim.species]
    return sim, g, species, n0, slack, state.fields, qms


@pytest.mark.parametrize("layout", ["brick_sort_p_home", "brick_sort_p_res"])
def test_residency_step_on_the_card_matches_the_cpu(cuda, layout):
    sim, g, species, n0, slack, fields, qms = _fired()
    sort = getattr(FP3, layout)
    out = [sort(sp, g, extent=n, slack=slack) for sp, n in zip(species, n0)]
    homes = [h for _, h in out]
    for (sp, _), h in zip(out, homes):
        full = h[sp.live.view(-1, FP3.BLOCK).any(1)].long()
        assert int(torch.bincount(full).min()) >= 8
    sps = [_to(sp, cuda) for sp, _ in out]
    homes_c = [h.to(cuda) for h in homes]
    fcoef = I.load_interpolator(fields, g).to(cuda)
    acc = torch.zeros((g.nv, 12), device=cuda)
    pushed, _, emits, obx, ores, _ = FP3.fused_push3d_multi(
        sps, fcoef, acc, g, qms, homes=homes_c, residency=True)
    _, spid, usable = RES.static_layout([sp.capacity for sp in pushed])
    torch.cuda.synchronize()
    c0 = RES.rebuckets_by_cause()
    pk = RES.plan(pushed, emits, obx, ores, homes_c, spid, usable, g)
    torch.cuda.synchronize()
    c1 = RES.rebuckets_by_cause()
    cpu = lambda t: t.to("cpu")
    pushed_h = [_to(sp, "cpu") for sp in pushed]
    emits_h = [cpu(e) for e in emits]
    obx_h = FP3.Outbox(f=cpu(obx.f), vox=cpu(obx.vox), valid=cpu(obx.valid))
    pr = RES.plan(pushed_h, emits_h, obx_h, cpu(ores), homes, spid, usable,
                  g)
    c2 = RES.rebuckets_by_cause()
    for n in ("rebuild", "overflow", "misplaced"):
        assert bool(getattr(pk, n)) == bool(getattr(pr, n)), n
    card = {k: c1[k] - c0[k] for k in RES.CAUSES}
    plain = {k: c2[k] - c1[k] for k in RES.CAUSES}
    assert card == plain
    if layout == "brick_sort_p_home":
        assert int(ores) > 0 and card["outbox"] == 1
        # the rebucket, on both devices
        rk = [FP3.brick_sort_p_res(sp, g, extent=n, slack=slack)
              for sp, n in zip(pushed, n0)]
        rc = [FP3.brick_sort_p_res(sp, g, extent=n, slack=slack)
              for sp, n in zip(pushed_h, n0)]
        for (a, ha), (b, hb) in zip(rk, rc):
            assert torch.equal(cpu(ha), hb)
            assert np.array_equal(_rows(a), _rows(b))
    else:
        assert int(ores) == 0 and sum(card.values()) == 0
        assert not bool(pk.rebuild)
        assert torch.equal(cpu(pk.a_j), pr.a_j)
        assert torch.equal(cpu(pk.starts_j), pr.starts_j)
        mk = RES.merge_p(pushed, emits, pk.compact, pk.starts_j, pk.a_j,
                         [_to(sp, cuda) for sp in pushed])
        mr = RES.merge_p_ref(pushed_h, emits_h, pr.compact, pr.starts_j,
                             pr.a_j, [_to(sp, "cpu") for sp in pushed_h])
        torch.cuda.synchronize()
        for a, b, n in zip(mk, mr, n0):
            assert int(a.np) == int(b.np) == n
            assert np.array_equal(_rows(a), _rows(b))


def test_cell_deck_rebuckets_at_most_once_in_ten_steps(cuda):
    sim = reconnection.build(reconnection.ReconnectionParams(**CELL))
    assert sim._residency_mode()[0]
    state = sim.initialize()
    n0 = [int(sp.np) for sp in state.species]
    step = sim.make_step()
    sim.relayouts = 0
    torch.cuda.synchronize()
    c0 = RES.rebuckets_by_cause()
    for _ in range(10):
        state = step(state)
    SG.settle()
    torch.cuda.synchronize()
    c1 = RES.rebuckets_by_cause()
    causes = {k: c1[k] - c0[k] for k in RES.CAUSES}
    rebuckets = int(state.diag["_res_rebuckets"])
    print(f"32^3 x 128 reconnection, 10 steps: {rebuckets} rebuckets, "
          f"by cause {causes}, {sim.relayouts} relayouts")
    assert sim.relayouts == 2
    assert sum(causes.values()) == rebuckets
    assert causes["outbox"] + causes["exchange"] <= 1
    assert [int(sp.np) for sp in state.species] == n0
    assert int(state.diag["unfinished"]) == 0
