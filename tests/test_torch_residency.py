"""The port's residency exchange against vpic_tpu/ops/residency.py: the
static layout helpers, block_counts, plan_exchange and any_misplaced equal
to the JAX package's on the crafted inputs of tests/test_residency.py and on
random ones, and merge_p_ref equal to the Pallas merge (interpret mode) in
every lane, dead lanes included, both into new tensors and in place.  All of it is integer routing and pure data
movement, so every tolerance is zero."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu.grid as GJ
import vpic_tpu.ops.residency as RESJ
import vpic_tpu.state as SJ
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.residency as RES
import vpic_tpu_torch.state as ST

import plan_cases as PC
from plan_cases import PLAN_CASES, crafted_outbox, random_outbox, to_outbox
from torch_parity import np_

torch.set_num_threads(2)

FIELDS = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live")


def _grids(n=16):
    kw = dict(dt=0.05, cvac=1.0, eps0=1.0)
    return (GJ.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, n, **kw),
            GT.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, n, **kw))


def _pair(arrs):
    return (SJ.SpeciesState(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            ST.SpeciesState(**{k: torch.as_tensor(np.array(v))
                               for k, v in arrs.items()}))


@pytest.mark.parametrize("caps", [[24576], [24000, 3072], [1024, 1500, 0]])
def test_static_layout_matches(caps):
    nj, sj, uj = RESJ.static_layout(caps)
    nt, st, ut = RES.static_layout(caps)
    assert nj == nt and np.array_equal(sj, st) and np.array_equal(uj, ut)


@pytest.mark.parametrize("n0,caps", [([5000], [24000]), ([5000], [12000]),
                                     ([5000], [9000]),
                                     ([2048, 3000], [60000, 60000])])
def test_slack_and_extents_match(n0, caps):
    gj, gt = _grids()
    s = RES.slack_blocks(gt, n0, caps)
    assert s == RESJ.slack_blocks(gj, n0, caps)
    assert RES.extents(gt, n0, s) == RESJ.extents(gj, n0, s)
    assert RES.max_routed(37) == RESJ.max_routed(37)
    assert RES.max_routed(4000) == RESJ.max_routed(4000)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_exchange_matches(case):
    c = PLAN_CASES[case]
    gj, gt = _grids()
    nblocks = len(c["homes"])
    rng = np.random.default_rng(c["seed"])
    make = crafted_outbox if case.startswith("crafted") else random_outbox
    obx = make(gt, nblocks, c["out_cap"], c["seed"])
    free = np.asarray(c["free"] if c["free"] is not None
                      else rng.integers(0, 200, nblocks), np.int32)
    homes = np.asarray(c["homes"], np.int32)
    spid = np.asarray(c["spid"], np.int32)
    usable = np.asarray(c["usable"], bool)
    cj, sj, aj, oj, stj = RESJ.plan_exchange(
        jnp.asarray(obx), jnp.asarray(homes), spid, usable,
        jnp.asarray(free), gj, inb=c["inb"])
    ct, st, at, ot, stt = RES.plan_exchange(
        to_outbox(obx), torch.as_tensor(homes), spid, usable,
        torch.as_tensor(free), gt, inb=c["inb"])
    assert np.array_equal(np.asarray(aj), np_(at))
    assert np.array_equal(np.asarray(sj), np_(st))
    assert bool(oj) == bool(ot)
    assert np.array_equal(np.asarray(stj), np_(stt))
    cj = np.asarray(cj)
    n = ct.vox.shape[0]
    assert np.array_equal(cj[[0, 1, 2, 4, 5, 6, 7], :n], np_(ct.f))
    assert np.array_equal(cj[3, :n].astype(np.int32), np_(ct.vox))
    assert not cj[:, n:].any()           # JAX's zero padding
    assert int(ct.valid.sum()) == int(obx[8].sum())
    assert np.asarray(aj).sum() > 0


def _layout_species(rng, g, N, homes, live_frac=0.7):
    """Lanes packed at block fronts on voxels of their block's home brick,
    except a few strays, with random emit marks."""
    nb = N // 1024
    live = np.sort(~(rng.random((nb, 1024)) < live_frac), axis=1) == False
    live = live.reshape(-1)
    nbx = g.nx // 8
    brick = np.repeat(homes, 1024)
    bx, by, bz = brick % nbx, (brick // nbx) % nbx, brick // (nbx * nbx)
    x = bx * 8 + rng.integers(1, 9, N)
    y = by * 8 + rng.integers(1, 9, N)
    z = bz * 8 + rng.integers(1, 9, N)
    stray = rng.random(N) < 0.002
    x = np.where(stray, (x % g.nx) + 1, x)
    vox = np.where(live, x + g.NX * (y + g.NY * z), 0).astype(np.int32)
    f = lambda: rng.normal(size=N).astype(np.float32)
    arrs = dict(dx=f(), dy=f(), dz=f(), i=vox, ux=f(), uy=f(), uz=f(),
                w=np.abs(f()) + 0.5, live=live, np=np.int32(live.sum()))
    emit = (rng.random(N) < 0.1) & live
    return arrs, emit


def test_block_counts_and_misplaced_match():
    gj, gt = _grids()
    rng = np.random.default_rng(11)
    homes = [np.asarray([0, 1, 2, 3], np.int32),
             np.asarray([4, 5, 6], np.int32)]
    sps_j, sps_t, em_j, em_t = [], [], [], []
    for h in homes:
        arrs, emit = _layout_species(rng, gt, 1024 * len(h), h)
        a, b = _pair(arrs)
        sps_j.append(a)
        sps_t.append(b)
        em_j.append(jnp.asarray(emit.astype(np.float32)))
        em_t.append(torch.as_tensor(emit))
    assert np.array_equal(np.asarray(RESJ.block_counts(sps_j, em_j)),
                          np_(RES.block_counts(sps_t, em_t)))
    hj = [jnp.asarray(h) for h in homes]
    ht = [torch.as_tensor(h) for h in homes]
    mis_j = bool(RESJ.any_misplaced(sps_j, em_j, hj, gj))
    mis_t = bool(RES.any_misplaced(sps_t, em_t, ht, gt))
    assert mis_j == mis_t
    # without the strays nothing is misplaced in either
    fixed_t = [s.replace(i=torch.where(s.live & (FP3.brick_of(s.i, gt).long()
                                                 != h.long().repeat_interleave(
                                                     1024)), 0, s.i))
               for s, h in zip(sps_t, ht)]
    fixed_j = [s.replace(i=jnp.asarray(np_(t.i))) for s, t in
               zip(sps_j, fixed_t)]
    fixed_t = [s.replace(live=s.live & (s.i > 0)) for s in fixed_t]
    fixed_j = [s.replace(live=jnp.asarray(np_(t.live))) for s, t in
               zip(fixed_j, fixed_t)]
    assert not bool(RES.any_misplaced(fixed_t, em_t, ht, gt))
    assert not bool(RESJ.any_misplaced(fixed_j, em_j, hj, gj))


def _layouts_inputs():
    """test_block_counts_and_misplaced_match's layouts (strays included)
    with a random outbox, as plan's arguments."""
    g = _grids()[1]
    rng = np.random.default_rng(11)
    homes = [np.asarray([0, 1, 2, 3], np.int32),
             np.asarray([4, 5, 6], np.int32)]
    sps, emits = [], []
    for h in homes:
        arrs, emit = _layout_species(rng, g, 1024 * len(h), h)
        sps.append(_pair(arrs)[1])
        emits.append(torch.as_tensor(emit))
    _, spid, usable = RES.static_layout([sp.capacity for sp in sps])
    obx = to_outbox(random_outbox(g, 7, 64, 5))
    return ((sps, emits, obx, torch.tensor(0, dtype=torch.int32),
             [torch.as_tensor(h) for h in homes], spid, usable, g), {})


@pytest.mark.parametrize("case", PC.CASES + ["layouts"])
def test_plan_matches_the_plain_functions(case):
    """plan on CPU tensors is block_counts, plan_exchange, any_misplaced
    and the rebuild bool, exactly."""
    args, kw = (_layouts_inputs() if case == "layouts"
                else PC.plan_inputs(case))
    sps, emits, obx, ores, homes, spid, usable, g = args
    launched = RES.plan_launches
    got = RES.plan(*args, **kw)
    assert RES.plan_launches == launched
    free_j = RES.block_counts(sps, emits)
    compact, starts_j, a_j, overflow, stats = RES.plan_exchange(
        obx, torch.cat(homes), spid, usable, free_j, g, **kw)
    misplaced = RES.any_misplaced(sps, emits, homes, g)
    want = RES.Plan(compact, starts_j, a_j,
                    overflow | (ores > 0) | misplaced, stats, overflow,
                    misplaced)
    PC.assert_plans_equal(got, want, whole=True)
    if case in ("stray", "layouts"):
        assert bool(got.misplaced) and bool(got.rebuild)
    if case == "roomy":
        assert not bool(got.rebuild) and int(got.a_j.sum()) > 0
    if case == "over_maxin":
        assert int(got.stats[0]) > RES.max_routed(300) == 32768
        assert bool(got.overflow)
    if case == "outbox_cap":
        assert bool(got.rebuild) and not bool(got.overflow)


@pytest.mark.parametrize("case", PC.CASES)
def test_plan_counts_its_rebucket_by_cause(case):
    """A plan that decides a rebucket counts it once, under the first cause
    its flags give (residency.CAUSES): leavers past an outbox cap, an
    exchange overflow, misplaced lanes alone; a merge counts nothing."""
    args, kw = PC.plan_inputs(case)
    before = RES.rebuckets_by_cause()
    RES.plan(*args, **kw)
    after = RES.rebuckets_by_cause()
    want = PC.cause(RES.plan_ref(*args, **kw), args[3])
    assert {k: after[k] - before[k] for k in RES.CAUSES} == \
        {k: int(k == want) for k in RES.CAUSES}
    assert want == PC.CAUSE_OF.get(case, want)


def _bad(args, which):
    """plan's arguments with one of them made wrong."""
    sps, emits, obx, ores, homes, spid, usable, g = args
    sp0 = sps[0]
    bad = dict(
        live_dtype=lambda: ([sp0.replace(live=sp0.live.to(torch.uint8))]
                            + sps[1:], emits, obx),
        vox_dtype=lambda: ([sp0.replace(i=sp0.i.long())] + sps[1:], emits,
                           obx),
        emit_shape=lambda: (sps, [emits[0][:-1]] + emits[1:], obx),
        emit_count=lambda: (sps, emits[:1], obx),
        homes_dtype=lambda: (sps, emits, obx),
        homes_shape=lambda: (sps, emits, obx),
        rows=lambda: (sps, emits, obx._replace(
            f=obx.f[:, :-1].contiguous(), vox=obx.vox[:-1].contiguous(),
            valid=obx.valid[:-1].contiguous())),
        f_dtype=lambda: (sps, emits, obx._replace(f=obx.f.double())),
        vox_device=lambda: (sps, emits, obx._replace(
            vox=torch.empty_like(obx.vox, device="meta"))),
        ores=lambda: (sps, emits, obx),
        spid=lambda: (sps, emits, obx),
        usable=lambda: (sps, emits, obx),
    )
    s, e, o = bad[which]()
    if which == "homes_dtype":
        homes = [h.long() for h in homes]
    if which == "homes_shape":
        homes = [h[:-1] for h in homes]
    if which == "ores":
        ores = ores.long()
    if which == "spid":
        spid = np.zeros_like(spid)
    if which == "usable":
        usable = usable[:-1]
    return s, e, o, ores, homes, spid, usable, g


@pytest.mark.parametrize("which", [
    "live_dtype", "vox_dtype", "emit_shape", "emit_count", "homes_dtype",
    "homes_shape", "rows", "f_dtype", "vox_device", "ores", "spid",
    "usable"])
def test_plan_refuses_wrong_inputs(which):
    args, kw = PC.plan_inputs("random")
    RES.plan(*args, **kw)
    err = TypeError if which.endswith("_dtype") else ValueError
    with pytest.raises(err):
        RES.plan(*_bad(args, which), **kw)


def _dest(sps_t, dest):
    """The merge's destination: the input species themselves ("aliased", as
    the step merges in place) or new tensors filled with junk ("new"), so
    that every slot must be written."""
    if dest == "aliased":
        return list(sps_t)
    junk = {"live": True, "i": -7}
    return [sp.replace(**{n: torch.full_like(getattr(sp, n),
                                             junk.get(n, float("nan")))
                          for n in FIELDS}) for sp in sps_t]


def _merge_both(arrs_list, emits, compact, starts, a, dest):
    """vpic_tpu's merge, run and read first, then the port's plain version
    into ``dest`` (see _dest)."""
    sps_j, sps_t = zip(*[_pair(a_) for a_ in arrs_list])
    out_j = RESJ.merge_p(list(sps_j),
                         [jnp.asarray(e.astype(np.float32)) for e in emits],
                         jnp.asarray(compact), jnp.asarray(starts),
                         jnp.asarray(a))
    out_j = [SimpleNamespace(**{n: np.asarray(getattr(o, n))
                                for n in FIELDS + ("np",)}) for o in out_j]
    M = compact.shape[1] - 128          # JAX's compact carries 128 pad cols
    out = _dest(sps_t, dest)
    out_t = RES.merge_p(list(sps_t), [torch.as_tensor(e) for e in emits],
                        FP3.Outbox(
                            f=torch.as_tensor(compact[[0, 1, 2, 4, 5, 6, 7],
                                                      :M]),
                            vox=torch.as_tensor(
                                compact[3, :M].astype(np.int32)),
                            valid=torch.ones(M, dtype=torch.bool)),
                        torch.as_tensor(starts), torch.as_tensor(a), out)
    for o, d in zip(out_t, out):
        assert all(getattr(o, n) is getattr(d, n) for n in FIELDS)
    return out_j, out_t


def _assert_merge_equal(out_j, out_t):
    for a, b in zip(out_j, out_t):
        for n in FIELDS + ("np",):
            x, y = np.asarray(getattr(a, n)), np_(getattr(b, n))
            assert x.dtype == y.dtype, n
            assert np.array_equal(x, y), n


DESTS = ["new", "aliased"]


@pytest.mark.parametrize("dest", DESTS)
def test_merge_p_ref_matches_crafted(dest):
    """The inputs of test_residency.py:175-223."""
    N = 2048
    rng = np.random.default_rng(0)
    f = lambda: rng.normal(size=N).astype(np.float32)
    live = rng.random(N) < 0.7
    live = np.sort(~live.reshape(-1, 1024), axis=1).reshape(-1) == False
    emit = (rng.random(N) < 0.1) & live
    arrs = dict(dx=f(), dy=f(), dz=f(),
                i=rng.integers(1, 4000, N).astype(np.int32), ux=f(), uy=f(),
                uz=f(), w=np.abs(f()) + 0.5, live=live,
                np=np.int32(live.sum()))
    M = 512
    compact = np.zeros((8, M + 128), np.float32)
    compact[0, :200] = rng.normal(size=200)
    compact[3, :200] = rng.integers(1, 4000, 200)
    compact[7, :200] = 1.0
    starts = np.asarray([3, 150], np.int32)
    a = np.asarray([5, 6], np.int32)
    _assert_merge_equal(*_merge_both([arrs], [emit], compact, starts, a,
                                     dest))


@pytest.mark.parametrize("dest", DESTS)
def test_merge_p_ref_matches_every_block_kind(dest):
    """Two species and every kind of block the Pallas merge branches on: a
    dead block (no keepers, no newcomers; its dead lanes hold junk), one
    whose keepers do not move, one whose keepers move a little (banded) and
    one with heavy churn (full), with and without newcomers."""
    rng = np.random.default_rng(5)
    arrs_list, emits = [], []
    for nb in (4, 3):
        N = nb * 1024
        f = lambda: rng.normal(size=N).astype(np.float32)
        live = np.zeros((nb, 1024), bool)
        live[0, :] = False                           # dead block
        live[1, :700] = True                         # keepers stay put
        live[2, :900] = True                         # banded
        if nb > 3:
            live[3, :1000] = True                    # full churn
        emit = np.zeros((nb, 1024), bool)
        emit[1, 650:700] = True                      # only trailing lanes
        emit[2, rng.choice(900, 60, False)] = True
        if nb > 3:
            emit[3, :400] = True
        arrs = dict(dx=f(), dy=f(), dz=f(),
                    i=rng.integers(1, 4000, N).astype(np.int32), ux=f(),
                    uy=f(), uz=f(), w=np.abs(f()) + 0.5,
                    live=live.reshape(-1), np=np.int32(live.sum()))
        arrs_list.append(arrs)
        emits.append(emit.reshape(-1))
    M = 1024
    compact = np.zeros((8, M + 128), np.float32)
    compact[:, :M] = rng.normal(size=(8, M))
    compact[3, :M] = rng.integers(1, 4000, M)
    starts = np.asarray([0, 3, 200, 333, 700, 801, 990], np.int32)
    a = np.asarray([0, 40, 0, 128, 0, 17, 34], np.int32)
    out_j, out_t = _merge_both(arrs_list, emits, compact, starts, a,
                               dest)
    _assert_merge_equal(out_j, out_t)
    # the dead block kept its rows, with w zeroed on dead lanes
    assert torch.equal(out_t[1].dx[:1024],
                       torch.as_tensor(arrs_list[1]["dx"][:1024]))
    assert not out_t[1].w[:1024].any() and not out_t[1].live[:1024].any()


@pytest.mark.parametrize("dest", DESTS)
@pytest.mark.parametrize("seed", [1, 2])
def test_merge_p_ref_matches_random(seed, dest):
    rng = np.random.default_rng(seed)
    g = _grids()[1]
    homes = rng.integers(0, 8, 6).astype(np.int32)
    arrs, emit = _layout_species(rng, g, 6 * 1024, homes, live_frac=0.6)
    M = 2048
    compact = np.zeros((8, M + 128), np.float32)
    compact[:, :M] = rng.normal(size=(8, M))
    compact[3, :M] = rng.integers(1, 4000, M)
    starts = np.sort(rng.integers(0, M - 128, 6)).astype(np.int32)
    a = rng.integers(0, 128, 6).astype(np.int32)
    out_j, out_t = _merge_both([arrs], [emit], compact, starts, a, dest)
    _assert_merge_equal(out_j, out_t)


def test_slice_and_join():
    """The step's extent slice is a view of the state, and the rebucket's
    copy writes its sorted extent into that view: the state's tensors take
    the sort, the dead capacity tail is untouched."""
    rng = np.random.default_rng(2)
    arrs, _ = _layout_species(rng, _grids()[1], 4096, np.arange(4))
    _, sp = _pair(arrs)
    spE = RES.slice_species(sp, 2048)
    assert spE.capacity == 2048 and spE.dx.data_ptr() == sp.dx.data_ptr()
    tail = {n: getattr(sp, n)[2048:].clone() for n in FIELDS}
    src = spE.replace(**{n: getattr(spE, n).clone() for n in FIELDS})
    src = src.replace(dx=src.dx + 1.0, live=~src.live,
                      np=torch.tensor(7, dtype=torch.int32))
    back = RES.copy_species(spE, src)
    assert back.dx.data_ptr() == sp.dx.data_ptr() and int(back.np) == 7
    for n in FIELDS:
        assert torch.equal(getattr(sp, n)[:2048], getattr(src, n)), n
        assert torch.equal(getattr(sp, n)[2048:], tail[n]), n


def test_merge_p_refuses_a_wrong_destination():
    """One destination per species, with the species' lane count."""
    rng = np.random.default_rng(4)
    arrs, emit = _layout_species(rng, _grids()[1], 2048, np.arange(2))
    _, sp = _pair(arrs)
    compact = FP3.Outbox(f=torch.zeros((7, 4)),
                         vox=torch.zeros(4, dtype=torch.int32),
                         valid=torch.zeros(4, dtype=torch.bool))
    starts = torch.zeros(2, dtype=torch.int32)
    args = ([sp], [torch.as_tensor(emit)], compact, starts, starts)
    with pytest.raises(ValueError):
        RES.merge_p(*args, [])
    with pytest.raises(ValueError):
        RES.merge_p(*args, [RES.slice_species(sp, 1024)])
    [out] = RES.merge_p(*args, [sp])
    assert int(out.np) == int(out.live.sum()) == int(arrs["live"].sum()
                                                      - emit.sum())
