"""The residency path's brick sort (``fused_push3d.brick_sort_p_res``), on
the CPU: each brick's stably sorted lanes dealt round-robin over its blocks.

* Where every brick fits one block, and in the tight-packing fallback, it
  is ``brick_sort_p_home`` bit for bit (which tests/test_torch_brick_sort.py
  holds to vpic_tpu's).
* At two or more blocks a brick: the source index equals a numpy deal of
  the stable brick order (sorted lane r of a brick to its block r mod nfull,
  column r div nfull); the home map and each brick's live lanes (as a
  multiset) equal brick_sort_p_home's; each block's live lanes are a prefix;
  a brick's blocks differ by at most one lane and its slack blocks stay
  empty; on voxel-sorted lanes no block holds more than ceil(n_v / nfull)
  + 1 lanes of a voxel v of n_v lanes.
* The outbox: on a 16^3 x 32 ppc reconnection deck (wpe/wce 1.5) right
  after its step-0 firing, whose T&A ops leave each voxel's lanes together,
  the residency epilogue overflows the outbox on brick_sort_p_home's layout
  and not on the interleaved one; over 10 steps of that deck the old layout
  rebuckets on most steps (every one an outbox overflow) and the
  interleaved one on none."""

import numpy as np
import pytest
import torch

import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.interp as I
import vpic_tpu_torch.ops.residency as RES
from vpic_tpu_torch.models import reconnection
from vpic_tpu_torch.state import SpeciesState

torch.set_num_threads(2)

Q = FP3.BLOCK
HOT = dict(nx=16, ny=16, nz=16, nppc=32, Lx=8.0, Ly=8.0, Lz=8.0,
           wpe_wce=1.5, tau_coll_interval=5)


def _grid(n=16):
    return GT.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, n, dt=0.05,
                                     cvac=1.0, eps0=1.0)


def _species(g, N, n_live, seed, packed=False, by_voxel=False):
    """``n_live`` live lanes on random interior voxels (scattered over the
    ``N`` slots unless ``packed``; in voxel order, live lanes first, with
    ``by_voxel``), dead lanes with voxel 0."""
    rng = np.random.default_rng(seed)
    live = np.zeros(N, bool)
    live[np.arange(n_live) if packed or by_voxel
         else rng.choice(N, n_live, False)] = True
    xyz = [rng.integers(1, m + 1, N) for m in (g.nx, g.ny, g.nz)]
    vox = np.where(live, xyz[0] + g.NX * (xyz[1] + g.NY * xyz[2]), 0)
    if by_voxel:
        vox[:n_live] = np.sort(vox[:n_live])
    f = lambda: torch.as_tensor(rng.uniform(-1, 1, N).astype(np.float32))
    return SpeciesState(
        dx=f(), dy=f(), dz=f(), i=torch.as_tensor(vox.astype(np.int32)),
        ux=f(), uy=f(), uz=f(),
        w=torch.as_tensor(rng.uniform(0.5, 1.5, N).astype(np.float32)),
        live=torch.as_tensor(live), np=torch.tensor(n_live, dtype=torch.int32))


def _keys(sp, g):
    nb = FP3.nbricks(g)
    return torch.where(sp.live, FP3.brick_of(sp.i, g), nb), nb


def _dealt(b, nb, N, slack):
    """numpy: the interleaved quantized layout's source index (-1 for an
    empty slot), from the stable brick order."""
    order = np.argsort(b, kind="stable")
    totb = np.bincount(b, minlength=nb + 1)[:nb]
    nfull = -(-totb // Q)
    qoff = np.concatenate([[0], np.cumsum((nfull + slack) * Q)])
    assert qoff[-1] <= N
    src = np.full(N, -1)
    seg = np.concatenate([[0], np.cumsum(totb)])
    for k in range(nb):
        r = np.arange(totb[k])
        src[qoff[k] + (r % max(nfull[k], 1)) * Q + r // max(nfull[k], 1)] = \
            order[seg[k]:seg[k + 1]]
    return src


# (capacity, live lanes, extent, slack); 5000 or 6000 lanes in the 8 bricks
# of 16^3 fit one block a brick; 7168 slots take the tight fallback
ONE_BLOCK = [(24576, 5000, 0, 0), (24576, 5000, 5000, 1),
             (24000, 5000, 5000, 0), (24576, 5000, 5000, 2),
             (7168, 6000, 0, 0), (7168, 6000, 6000, 0)]


@pytest.mark.parametrize("N,n_live,extent,slack", ONE_BLOCK)
def test_one_block_a_brick_is_brick_sort_p_home(N, n_live, extent, slack):
    g = _grid()
    sp = _species(g, N, n_live, N + n_live + slack, packed=bool(extent))
    a, ha = FP3.brick_sort_p_home(sp, g, extent=extent, slack=slack)
    b, hb = FP3.brick_sort_p_res(sp, g, extent=extent, slack=slack)
    assert torch.equal(ha, hb)
    for n in FP3.LANE_FIELDS + ("np",):
        assert torch.equal(getattr(a, n), getattr(b, n)), n


def test_tight_fallback_packs_as_brick_sort_p_home():
    """28,000 lanes (~3,500 a brick, 4 blocks each) in 30,720 slots: the
    quantized layout does not fit, so the lanes pack tight in brick order,
    the blocks spanning two bricks."""
    g = _grid()
    sp = _species(g, 30 * Q, 28000, 7)
    a, ha = FP3.brick_sort_p_home(sp, g)
    b, hb = FP3.brick_sort_p_res(sp, g)
    assert b.live[:28000].all() and not b.live[28000:].any()
    assert torch.equal(ha, hb)
    for n in FP3.LANE_FIELDS:
        assert torch.equal(getattr(a, n), getattr(b, n)), n


# (capacity, live lanes, slack, voxel-sorted input): 2-6 blocks a brick
MANY_BLOCKS = [(64 * Q, 24000, 0, False), (64 * Q, 24000, 1, True),
               (96 * Q, 40000, 2, True), (48 * Q, 17000, 1, False)]


@pytest.mark.parametrize("N,n_live,slack,by_voxel", MANY_BLOCKS)
def test_source_index_is_the_deal_of_the_brick_order(N, n_live, slack,
                                                     by_voxel):
    g = _grid()
    sp = _species(g, N, n_live, n_live + slack, by_voxel=by_voxel)
    b, nb = _keys(sp, g)
    src, home = FP3._sort_src_q(b, nb, N, Q, nhome=N // Q, slack=slack,
                                interleave=True)
    _, home0 = FP3._sort_src_q(b, nb, N, Q, nhome=N // Q, slack=slack)
    assert np.array_equal(src.numpy(), _dealt(b.numpy(), nb, N, slack))
    assert torch.equal(home, home0)


def _per_brick_rows(sp, home):
    """{brick: sorted rows of its blocks' live lanes}"""
    cols = torch.stack([sp.i.to(torch.float64)]
                       + [getattr(sp, n).to(torch.float64)
                          for n in ("dx", "dy", "dz", "ux", "uy", "uz", "w")],
                       1).numpy()
    hl = home.to(torch.int64).repeat_interleave(Q)[:sp.capacity].numpy()
    live = sp.live.numpy()
    out = {}
    for k in np.unique(hl):
        rows = cols[live & (hl == k)]
        out[int(k)] = rows[np.lexsort(rows.T[::-1])]
    return out


@pytest.mark.parametrize("N,n_live,slack,by_voxel", MANY_BLOCKS)
def test_blocks_share_their_brick_evenly(N, n_live, slack, by_voxel):
    g = _grid()
    sp = _species(g, N, n_live, n_live + slack, by_voxel=by_voxel)
    a, ha = FP3.brick_sort_p_home(sp, g, slack=slack)
    b, hb = FP3.brick_sort_p_res(sp, g, slack=slack)
    assert torch.equal(ha, hb)
    ra, rb = _per_brick_rows(a, ha), _per_brick_rows(b, hb)
    assert ra.keys() == rb.keys()
    for k in ra:
        assert np.array_equal(ra[k], rb[k]), k
    assert int(b.live.sum()) == int(b.np) == n_live
    assert bool((b.w[~b.live] == 0).all())
    live = b.live.view(-1, Q)
    # a prefix: no live lane after a dead one in its block
    assert not bool((live[:, 1:] & ~live[:, :-1]).any())
    counts = live.sum(1).numpy()
    homes = hb.numpy()
    vox = b.i.view(-1, Q).numpy()
    several = 0
    for k in np.unique(homes):
        blocks = np.nonzero(homes == k)[0]
        c = counts[blocks]
        nfull = -(-int(c.sum()) // Q)
        several += nfull >= 2
        assert c[:nfull].max() - c[:nfull].min() <= 1, k
        assert not c[nfull:].any(), k              # the slack blocks
        if not by_voxel or nfull < 2:
            continue
        v, n_v = np.unique(vox[blocks][live[blocks].numpy()],
                           return_counts=True)
        cap = dict(zip(v, -(-n_v // nfull) + 1))
        for j in blocks[:nfull]:
            u, m = np.unique(vox[j][live[j].numpy()], return_counts=True)
            assert all(m_ <= cap[u_] for u_, m_ in zip(u, m)), (k, j)
    assert several >= 4


def _firing_state():
    """The hot 16^3 x 32 ppc deck just after its step-0 firing (three T&A
    ops from a seeded generator), on the residency extents."""
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
    return sim, g, species, n0, slack, I.load_interpolator(state.fields, g), qms


def test_epilogue_overflows_on_voxel_runs_and_not_interleaved():
    sim, g, species, n0, slack, fcoef, qms = _firing_state()
    ores = {}
    for sort in (FP3.brick_sort_p_home, FP3.brick_sort_p_res):
        out = [sort(sp, g, extent=n, slack=slack)
               for sp, n in zip(species, n0)]
        sps, homes = [o[0] for o in out], [o[1] for o in out]
        # several blocks a brick: ~8,200 lanes of each species in a brick
        for sp, h in zip(sps, homes):
            full = h[sp.live.view(-1, Q).any(1)].long()
            assert int(torch.bincount(full).min()) >= 8
        acc = torch.zeros((g.nv, 12), dtype=torch.float32)
        pushed, _, emits, _, o, _ = FP3.fused_push3d_multi_ref(
            sps, fcoef, acc, g, qms, homes=homes, residency=True)
        ores[sort.__name__] = (int(o), sum(int(e.sum()) for e in emits))
    (o_home, e_home), (o_res, e_res) = (ores["brick_sort_p_home"],
                                        ores["brick_sort_p_res"])
    assert o_home > 0 and o_res == 0
    assert e_home + o_home == e_res          # the same leavers


@pytest.mark.parametrize("layout", ["brick_sort_p_home", "interleaved"])
def test_hot_deck_rebuckets_by_layout(monkeypatch, layout):
    """10 residency steps (firings at steps 0 and 5): the old layout
    rebuckets on most steps, each an outbox overflow; the interleaved
    layout on none.  Every lane is kept either way."""
    if layout == "brick_sort_p_home":
        home = FP3.brick_sort_p_home
        monkeypatch.setattr(FP3, "brick_sort_p_res",
                            lambda sp, g, extent=0, slack=0: home(
                                sp, g, extent=extent, slack=slack))
    sim = reconnection.build(reconnection.ReconnectionParams(**HOT),
                             device="cpu")
    state = sim.initialize()
    n0 = [int(sp.np) for sp in state.species]
    step = sim.make_step()
    c0 = RES.rebuckets_by_cause()
    for _ in range(10):
        state = step(state)
    c1 = RES.rebuckets_by_cause()
    causes = {k: c1[k] - c0[k] for k in RES.CAUSES}
    rebuckets = int(state.diag["_res_rebuckets"])
    assert sim.relayouts == 2
    assert sum(causes.values()) == rebuckets
    if layout == "interleaved":
        assert rebuckets == 0
    else:
        assert rebuckets >= 5 and causes["outbox"] == rebuckets
    assert [int(sp.np) for sp in state.species] == n0
    assert [int(sp.live.sum()) for sp in state.species] == n0
