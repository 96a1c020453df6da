"""Inputs of the residency exchange plan, shared by the plan's CPU tests
(tests/test_torch_residency.py) and its card tests
(tests/test_torch_cuda_plan.py).  numpy and torch only: the card's test
files import no jax."""

import zlib

import numpy as np
import torch

import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.residency as RES
import vpic_tpu_torch.state as ST


def grid(n=16):
    return GT.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, n, dt=0.05,
                                     cvac=1.0, eps0=1.0)


def crafted_outbox(g, nblocks, out_cap, seed):
    """test_residency.py:130-154: valid rows with voxels in bricks 0..2."""
    rng = np.random.default_rng(seed)
    obx = np.zeros((9, nblocks * out_cap), np.float32)
    dest_brick = rng.integers(0, 3, nblocks * out_cap)
    for r in range(nblocks * out_cap):
        b = dest_brick[r]
        bx, by, bz = b % 2, (b // 2) % 2, b // 4
        obx[3, r] = (bx * 8 + 1) + g.NX * ((by * 8 + 1) + g.NY * (bz * 8 + 1))
        obx[0, r] = rng.normal()
    valid = rng.random(nblocks * out_cap) < 0.2
    obx[8] = valid
    obx[3, ~valid] = 0.0
    return obx


def random_outbox(g, nblocks, out_cap, seed, valid_frac=0.4):
    rng = np.random.default_rng(seed)
    M = nblocks * out_cap
    obx = rng.normal(size=(9, M)).astype(np.float32)
    x = rng.integers(1, g.nx + 1, M)
    y = rng.integers(1, g.ny + 1, M)
    z = rng.integers(1, g.nz + 1, M)
    obx[3] = x + g.NX * (y + g.NY * z)
    obx[8] = rng.random(M) < valid_frac
    obx[:, obx[8] < 0.5] = 0.0
    return obx


def to_outbox(obx, device="cpu"):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return FP3.Outbox(f=t(obx[[0, 1, 2, 4, 5, 6, 7]]),
                      vox=t(obx[3].astype(np.int32)), valid=t(obx[8] > 0.5))


PLAN_CASES = {
    # test_residency.py:130-172: one species, 4 blocks, 8 bricks on 16^3
    "crafted": dict(homes=[0, 0, 1, 2], spid=[0] * 4, usable=[True] * 4,
                    free=[5, 3, 0, 7], out_cap=16, inb=8, seed=3),
    "crafted_roomy": dict(homes=[0, 0, 1, 2], spid=[0] * 4,
                          usable=[True] * 4, free=[40, 30, 0, 70],
                          out_cap=16, inb=64, seed=3),
    # two species, every brick, an unusable tail block, random free space
    "random": dict(homes=[0, 1, 2, 3, 4, 5, 6, 7, 7, 0, 2, 2, 5, 6, 7, 7],
                   spid=[0] * 9 + [1] * 7,
                   usable=[True] * 8 + [False] + [True] * 7,
                   free=None, out_cap=32, inb=128, seed=7),
}


def _brick_voxels(rng, g, bricks):
    """A random interior voxel of each of ``bricks`` (8^3 bricks)."""
    nbx, nby, _ = FP3._nb(g)
    bricks = np.asarray(bricks)
    bx, by, bz = bricks % nbx, (bricks // nbx) % nby, bricks // (nbx * nby)
    n = len(bricks)
    return ((bx * 8 + rng.integers(1, 9, n))
            + g.NX * ((by * 8 + rng.integers(1, 9, n))
                      + g.NY * (bz * 8 + rng.integers(1, 9, n))))


def layout_species(rng, g, caps, homes, free=None, strays=0):
    """Species of capacities ``caps`` laid out by block: block j of species
    k holds live lanes at random slots, kept ones on voxels of its home
    brick ``homes[k][j]``, emitted ones anywhere, so that its free slots
    (1024 - live + emitted) are ``free[j]`` where the block's lanes allow
    (random without ``free``).  ``strays`` kept lanes, spread over the
    species, sit in another brick.  Returns (species, emits) as numpy
    dicts and bool arrays."""
    nb = FP3.nbricks(g)
    out, emits, j = [], [], 0
    for N, home in zip(caps, homes):
        live = np.zeros(N, bool)
        emit = np.zeros(N, bool)
        for b in range(len(home)):
            lanes = min(1024, N - b * 1024)
            if free is None:
                held = int(rng.integers(0, lanes + 1))
            else:
                held = int(np.clip(1024 - free[j], 0, lanes))
            n_emit = int(rng.integers(0, lanes - held + 1))
            slots = b * 1024 + rng.choice(lanes, held + n_emit, False)
            live[slots] = True
            emit[slots[:n_emit]] = True
            j += 1
        vox = _brick_voxels(rng, g, np.repeat(home, 1024)[:N])
        anywhere = _brick_voxels(rng, g, rng.integers(0, nb, N))
        vox = np.where(emit, anywhere, vox)
        vox = np.where(live, vox, rng.integers(0, g.nv, N))
        f = lambda: rng.normal(size=N).astype(np.float32)
        out.append(dict(dx=f(), dy=f(), dz=f(), i=vox.astype(np.int32),
                        ux=f(), uy=f(), uz=f(), w=np.abs(f()) + 0.5,
                        live=live, np=np.int32(live.sum())))
        emits.append(emit)
    kept = [(k, s) for k, (a, e) in enumerate(zip(out, emits))
            for s in np.nonzero(a["live"] & ~e)[0]]
    for idx in rng.choice(len(kept), min(strays, len(kept)), False):
        k, s = kept[idx]
        home = homes[k][s // 1024]
        out[k]["i"][s] = _brick_voxels(rng, g, [(home + 1) % nb])[0]
    return out, emits


def plan_inputs(case, device="cpu"):
    """The arguments of residency.plan for one case: PLAN_CASES' names, and
    "many_keys" (three species on 32^3: 192 keys over 32 outbox rows a
    block, tiles of several blocks and chunks, a partial last tile),
    "stray" (a kept lane outside its home brick), "roomy" (two blocks of
    every brick and few rows: nothing overflows), "over_maxin" (every one
    of 38,400 outbox rows valid, past max_routed's 32,768),
    "outbox_cap" (roomy, with leavers past the outbox cap: ores > 0) and
    "roomy_stray" (roomy, with a stray: misplaced, nothing overflows).  Returns
    (args, kwargs) for plan(*args, **kwargs)."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case in PLAN_CASES:
        c = PLAN_CASES[case]
        g = grid()
        homes_all = np.asarray(c["homes"], np.int32)
        spid = np.asarray(c["spid"], np.int32)
        nblk = np.bincount(spid)
        usable = np.asarray(c["usable"], bool)
        # an unusable block is its species' partial tail block
        caps = [int(n) * 1024 - (601 if not usable[spid == k].all() else 0)
                for k, n in enumerate(nblk)]
        homes = np.split(homes_all, np.cumsum(nblk)[:-1])
        free = None if c["free"] is None else np.asarray(c["free"])
        arrs, emits = layout_species(rng, g, caps, homes, free)
        make = crafted_outbox if case.startswith("crafted") else random_outbox
        obx = make(g, len(spid), c["out_cap"], c["seed"])
        inb, ores = c["inb"], 0
    else:
        g = grid(32 if case == "many_keys" else 16)
        roomy = case in ("roomy", "outbox_cap", "roomy_stray")
        nblk = dict(many_keys=[11, 10, 10], stray=[6, 5],
                    over_maxin=[150, 150]).get(case, [16, 16])
        out_cap = dict(many_keys=32, over_maxin=128, stray=64).get(case, 32)
        nb = FP3.nbricks(g)
        homes = [np.sort(rng.integers(0, nb, n)).astype(np.int32)
                 for n in nblk]
        if roomy:
            homes = [np.repeat(np.arange(nb, dtype=np.int32), 2)] * 2
        caps = [n * 1024 for n in nblk]
        arrs, emits = layout_species(rng, g, caps, homes,
                                     strays=1 if case.endswith("stray")
                                     else 0)
        spid = np.repeat(np.arange(len(nblk)), nblk).astype(np.int32)
        usable = np.ones(len(spid), bool)
        obx = random_outbox(g, len(spid), out_cap, 11,
                            valid_frac=0.05 if roomy else dict(
                                over_maxin=1.0).get(case, 0.4))
        inb, ores = RES.INB, 5 if case == "outbox_cap" else 0
    t = lambda a: torch.as_tensor(a, device=device)
    sps = [ST.SpeciesState(**{k: t(v) for k, v in a.items()}) for a in arrs]
    return ((sps, [t(e) for e in emits], to_outbox(obx, device),
             torch.tensor(ores, dtype=torch.int32, device=device),
             [t(h) for h in homes], spid, usable, g), dict(inb=inb))


CASES = sorted(PLAN_CASES) + ["many_keys", "stray", "roomy", "over_maxin",
                              "outbox_cap", "roomy_stray"]
# the rebucket cause (residency.CAUSES) each case's plan decides, where it
# decides one
CAUSE_OF = {"outbox_cap": "outbox", "over_maxin": "exchange",
            "roomy_stray": "misplaced"}


def cause(plan, ores) -> str:
    """The cause a plan's flags give its rebucket (the first of residency.
    CAUSES that holds), or None where it merges."""
    if not bool(plan.rebuild):
        return None
    if int(ores) > 0:
        return "outbox"
    return "exchange" if bool(plan.overflow) else "misplaced"


def assert_plans_equal(k, r, whole=False):
    """Two residency.Plans equal bit for bit: the compact rows up to the
    routed total (``whole``: every row), the valid marks, starts_j, a_j,
    stats and the three flags, dtypes included."""
    n = r.compact.vox.shape[0] if whole else min(int(r.stats[0]),
                                                  r.compact.vox.shape[0])
    assert k.compact.f.shape == r.compact.f.shape
    assert torch.equal(k.compact.f[:, :n].view(torch.int32),
                       r.compact.f[:, :n].view(torch.int32))
    assert torch.equal(k.compact.vox[:n], r.compact.vox[:n])
    assert torch.equal(k.compact.valid, r.compact.valid)
    for name in ("starts_j", "a_j", "stats", "overflow", "misplaced",
                 "rebuild"):
        a, b = getattr(k, name), getattr(r, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
