"""Per-brick bucketed residency for the 3-D path (counterpart of
``vpic_tpu/ops/residency.py``).

Particles live in fixed per-brick block regions, set up by the quantized
brick sort with ``slack`` empty blocks per brick (``brick_sort_p_res``: each
brick's lanes dealt round-robin over its blocks), and migrate
incrementally:

* the push kernel copies each block's brick-leavers into the block's outbox
  and marks them emitted (``ops/fused_push3d``, residency=True);
* :func:`plan` plans the exchange: each block's free slots
  (:func:`block_counts`), the outbox rows routed to their destination
  bricks with one stable sort over the outbox rows only and allocated to
  the destination bricks' blocks by free space (:func:`plan_exchange`),
  whether a kept lane sits outside its home brick (:func:`any_misplaced`),
  and the step's rebuild bool.  On CUDA tensors it launches
  ``csrc/res_plan.cu`` (four launches for every species); on CPU tensors
  it runs the plain version ``plan_ref``, those three functions, which the
  CPU tests hold to the JAX package's;
* :func:`merge_p` drops the emitted lanes, compacts each block's keepers in
  lane order and appends the routed newcomers, so the species arrays are
  complete at every step boundary.  It writes into destination species that
  may be its input (the step merges in place into the state's extent
  slices).  On CUDA tensors it launches ``csrc/merge_p.cu`` once for every
  species; on CPU tensors it runs the plain version ``merge_p_ref``.  Neither
  wrapper falls back from one to the other.

When the exchange would overflow (a brick's inflow exceeds its free slots,
or more rows are routed than the compact bound), when a leaver exceeded the
outbox cap, or when a kept lane sits outside its home brick, the step
rebuckets with the full brick sort instead of merging.  Invariant after
every step: every live lane is interior to its home brick.  Each plan that
decides a rebucket counts it under its cause (``CAUSES``,
:func:`rebuckets_by_cause`): on the card the plan's last kernel adds to
device counters and writes them through to mapped host memory, so the
host reads them with no work on the device.

The JAX package's merge works around the TPU (``_prefix_excl`` triangular
matmuls, ``_bdot`` split-bf16 one-hot dots, the ``BAND`` fast paths, the
two prefetch-indexed 128-lane DMA windows of compact rows); the kernel here
is a block scan plus direct row moves, and none of that has a counterpart.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..grid import Grid
from ..state import SpeciesState
from . import _build
from .fused_push import (_check, _round_up, c_array, launch_plan,
                         packed_src_sort, species_groups)
from .fused_push3d import BLOCK, LANE_FIELDS, OUT_CAP, Outbox, _nb, \
    brick_of, chart_dims, nbricks

INB = 128         # per-block inbox cap (newcomers a block takes per step)
KERNEL = "merge_p"
PLAN_KERNEL = "res_plan"
PLAN_LAUNCHES = 4           # kernel launches a plan makes
MAX_PLAN_SPECIES = 32       # species one plan takes (the kernels' table)
PLAN_TILES = 1024           # the route's tiles of outbox rows, at most
PLAN_SMEM = 232448          # shared memory a block can use (a key a word)

# Kernel launches made by merge_p since the count was last reset.
launches = 0
# Kernel launches made by plan since the count was last reset.
plan_launches = 0
# The causes of a rebucket, the first that holds: leavers past a block's
# outbox cap (ores > 0; they stay, misplaced), an exchange overflow
# (Plan.overflow), misplaced lanes alone (Plan.misplaced).
CAUSES = ("outbox", "exchange", "misplaced")
# rebuckets by cause decided by plans on CPU tensors; on the card, per
# device index: (device counters the plan kernel adds to, the address of
# their mapped host copy, a view of that copy)
_cpu_causes = torch.zeros(len(CAUSES), dtype=torch.int64)
_card_causes: dict = {}


def static_layout(capacities, block: int = BLOCK):
    """Static block layout of the concatenated species: (nblocks_total,
    spid (nblocks,) int32 numpy, usable (nblocks,) bool numpy).  ``usable``
    is False for a block not entirely inside its species' capacity (the
    partial tail block): newcomers go only to whole blocks."""
    spids, usable = [], []
    for s, N in enumerate(capacities):
        nb = _round_up(N, block) // block
        spids += [s] * nb
        usable += [(j + 1) * block <= N for j in range(nb)]
    return (len(spids), np.asarray(spids, np.int32),
            np.asarray(usable, bool))


def slack_blocks(g: Grid, n0_list, capacities, block: int = BLOCK,
                 want: int = 4) -> int:
    """Largest per-brick slack (<= want) such that the quantized layout with
    slack fits every species' capacity under the no-growth live bound n0;
    0 when even a slack of 1 does not fit (residency stays off)."""
    nb = nbricks(g)
    for slack in range(want, 0, -1):
        if all(_round_up(max(n0, 1), block) + nb * (1 + slack) * block <= N
               for n0, N in zip(n0_list, capacities)):
            return slack
    return 0


def extents(g: Grid, n0_list, slack: int, block: int = BLOCK):
    """Per-species residency extents: the slack-padded quantized layout
    fits in the first E slots, so the whole residency path runs on [0, E)
    slices and the dead capacity tail never moves.  Multiples of block."""
    nb = nbricks(g)
    return [_round_up(max(n0, 1), block) + nb * (1 + slack) * block
            for n0 in n0_list]


def slice_species(sp: SpeciesState, E: int) -> SpeciesState:
    """View of the first E slots (residency keeps every live lane there)."""
    return sp.replace(**{n: getattr(sp, n)[:E] for n in LANE_FIELDS})


def copy_species(dst: SpeciesState, src: SpeciesState) -> SpeciesState:
    """Copies src's lane fields into dst's tensors (the rebucket's sorted
    extent into the state's slice, E slots a field); returns dst with
    src's np."""
    for n in LANE_FIELDS:
        getattr(dst, n).copy_(getattr(src, n))
    return dst.replace(np=src.np)


def block_counts(sps: Sequence[SpeciesState], emits,
                 block: int = BLOCK) -> torch.Tensor:
    """Per-block free slots after the merge drops the emitted lanes:
    block - (live - emitted), concatenated over species in block order
    (int32)."""
    frees = []
    for sp, emit in zip(sps, emits):
        N = sp.capacity
        pad = _round_up(N, block) - N
        live = torch.nn.functional.pad(sp.live.to(torch.int32), (0, pad))
        em = torch.nn.functional.pad(emit.to(torch.int32), (0, pad))
        n_live = live.view(-1, block).sum(1, dtype=torch.int32)
        n_emit = em.view(-1, block).sum(1, dtype=torch.int32)
        frees.append(block - (n_live - n_emit))
    return torch.cat(frees) if len(frees) > 1 else frees[0]


def max_routed(nblocks: int, out_cap: int = OUT_CAP) -> int:
    """Static cap on the rows routed in one step (the compact bound): half
    the worst case, ~6 % of the lanes crossing bricks per step.  More
    rebuckets instead."""
    return max(32768, _round_up(nblocks * out_cap // 2, 1024))


_STATIC: dict = {}


def _static_tensors(spid, usable, dev):
    """(spid, usable) of static_layout as int64 / bool tensors on ``dev``,
    plus the species count, copied to the device once per layout: a copy
    from host memory every step would wait for the device."""
    spid = np.asarray(spid, np.int32)
    usable = np.asarray(usable, bool)
    key = (spid.tobytes(), usable.tobytes(), str(dev))
    if key not in _STATIC:
        _STATIC[key] = (
            torch.as_tensor(spid, dtype=torch.int64, device=dev),
            torch.as_tensor(usable, dtype=torch.bool, device=dev),
            int(spid.max()) + 1 if len(spid) else 1)
    return _STATIC[key]


def plan_exchange(obx: Outbox, homes_cat: torch.Tensor, spid, usable,
                  free_j: torch.Tensor, g: Grid, inb: int = INB):
    """Route outbox rows to destination (species, brick) groups and allocate
    them greedily to the group's blocks by free space.

    Returns (compact, starts_j, a_j, overflow, stats): ``compact`` is an
    Outbox of the valid rows in destination-sorted order (at most
    max_routed rows); block j takes compact rows [starts_j, starts_j + a_j)
    (int32); ``overflow`` (0-d bool) is True when a group's inflow exceeds
    its allocatable slots or the routed total exceeds the compact bound --
    the caller must rebucket instead of merging; ``stats`` is (routed rows,
    max group shortfall)."""
    dev = obx.vox.device
    i64 = torch.int64
    nb = nbricks(g)
    nblocks = homes_cat.shape[0]
    out_cap = obx.vox.shape[0] // nblocks
    spid_t, usable_t, nsp = _static_tensors(spid, usable, dev)
    NKEY = nsp * nb

    dest = torch.clamp(brick_of(torch.clamp(obx.vox, min=1), g), 0, nb - 1)
    spid_r = spid_t.repeat_interleave(out_cap)
    key_r = torch.where(obx.valid, spid_r * nb + dest.to(i64), NKEY)
    N_OUT = key_r.shape[0]
    keys_sorted, sorted_src = packed_src_sort(key_r, N_OUT, NKEY + 1)
    ar = torch.arange(NKEY + 1, dtype=i64, device=dev)
    seg = torch.searchsorted(keys_sorted, ar)
    c_k = seg[1:] - seg[:-1]                                   # (NKEY,)

    key_j = spid_t * nb + homes_cat.to(i64)                    # nondecreasing
    cap_j = torch.where(usable_t, torch.clamp(free_j.to(i64), 0, inb), 0)
    csp = torch.cat([torch.zeros(1, dtype=i64, device=dev),
                     torch.cumsum(cap_j, 0)])
    j_start = torch.searchsorted(key_j, ar)
    off = csp[j_start]                                         # (NKEY+1,)
    capsum_k = off[1:] - off[:-1]                              # (NKEY,)
    overflow = torch.any(c_k > capsum_k)

    prefix_j = csp[:-1] - off[:-1][key_j]    # cap before j within group
    ck_j = c_k[key_j]
    q_j = torch.minimum(ck_j, prefix_j)
    a_j = torch.clamp(torch.minimum(cap_j, ck_j - q_j), min=0)
    starts_j = seg[key_j] + q_j

    # the valid rows are the sorted prefix [0, seg[NKEY]): bound it
    # statically and rebucket when exceeded
    MAXIN = max_routed(nblocks, out_cap)
    overflow = overflow | (seg[NKEY] > MAXIN)
    take = sorted_src[:MAXIN].to(i64)
    n_take = take.shape[0]
    compact = Outbox(
        f=obx.f[:, take].contiguous(), vox=obx.vox[take].contiguous(),
        valid=torch.arange(n_take, device=dev) < seg[NKEY])
    stats = torch.stack([seg[NKEY], torch.max(c_k - capsum_k)])
    return (compact, starts_j.to(torch.int32), a_j.to(torch.int32),
            overflow, stats)


def any_misplaced(sps: Sequence[SpeciesState], emits, homes, g: Grid,
                  block: int = BLOCK) -> torch.Tensor:
    """0-d bool: True when any live, non-emitted lane's voxel is outside
    its block's home brick (a capped leaver): the caller must rebucket to
    restore the interior-residency invariant."""
    out = torch.zeros((), dtype=torch.bool, device=sps[0].live.device)
    for sp, emit, home in zip(sps, emits, homes):
        N = sp.capacity
        hl = home.to(torch.int64).repeat_interleave(block)[:N]
        br = brick_of(torch.clamp(sp.i, min=1), g).to(torch.int64)
        out = out | torch.any(sp.live & ~emit & (br != hl))
    return out


class Plan(NamedTuple):
    """The exchange plan of one residency step.  ``compact``, ``starts_j``,
    ``a_j``, ``overflow`` and ``stats`` are plan_exchange's, ``misplaced``
    any_misplaced's, and ``rebuild`` (0-d bool) is overflow | (ores > 0) |
    misplaced: the step rebuckets instead of merging where it is True."""
    compact: Outbox
    starts_j: torch.Tensor
    a_j: torch.Tensor
    rebuild: torch.Tensor
    stats: torch.Tensor
    overflow: torch.Tensor
    misplaced: torch.Tensor


def plan_ref(sps: Sequence[SpeciesState], emits, obx: Outbox, ores, homes,
             spid, usable, g: Grid, inb: int = INB) -> Plan:
    """Plain PyTorch version of plan: block_counts, plan_exchange and
    any_misplaced, and the rebuild bool."""
    free_j = block_counts(sps, emits)
    homes_cat = torch.cat(homes) if len(homes) > 1 else homes[0]
    compact, starts_j, a_j, overflow, stats = plan_exchange(
        obx, homes_cat, spid, usable, free_j, g, inb)
    misplaced = any_misplaced(sps, emits, homes, g)
    return Plan(compact, starts_j, a_j, overflow | (ores > 0) | misplaced,
                stats, overflow, misplaced)


def _check_plan(sps: Sequence[SpeciesState], emits, obx: Outbox, ores,
                homes, spid, usable) -> List[int]:
    """Raise unless plan can take these inputs; returns each species'
    layout blocks."""
    if not sps or len(emits) != len(sps) or len(homes) != len(sps):
        raise ValueError(f"plan: {len(sps)} species, {len(emits)} emit "
                         f"marks and {len(homes)} home maps")
    dev = obx.vox.device
    nblk = []
    for k, (sp, em, h) in enumerate(zip(sps, emits, homes)):
        N = sp.capacity
        _check(sp.live, f"species[{k}].live", torch.bool, (N,), dev)
        _check(sp.i, f"species[{k}].i", torch.int32, (N,), dev)
        _check(em, f"emits[{k}]", torch.bool, (N,), dev)
        nblk.append(-(-N // BLOCK))
        _check(h, f"homes[{k}]", torch.int32, (nblk[-1],), dev)
    total = sum(nblk)
    M = obx.vox.shape[0] if obx.vox.dim() == 1 else 0
    if total == 0 or M == 0 or M % total:
        raise ValueError(f"plan: {M} outbox rows for {total} layout blocks")
    _check(obx.vox, "obx.vox", torch.int32, (M,), dev)
    _check(obx.valid, "obx.valid", torch.bool, (M,), dev)
    _check(obx.f, "obx.f", torch.float32, (7, M), dev)
    if ores.device != dev or ores.dtype != torch.int32 or ores.numel() != 1:
        raise ValueError(f"plan: ores must be one int32 on {dev}, not "
                         f"{tuple(ores.shape)} {ores.dtype} on {ores.device}")
    if not np.array_equal(np.asarray(spid),
                          np.repeat(np.arange(len(sps)), nblk)):
        raise ValueError("plan: spid is not the species' static_layout")
    if np.asarray(usable).shape != (total,):
        raise ValueError(f"plan: usable has shape "
                         f"{np.asarray(usable).shape}, expected ({total},)")
    return nblk


def _div_magic(d: int):
    """The magic and two shifts with which res_plan.cu's div_by divides an
    unsigned 32-bit n by d >= 1 exactly (Granlund and Montgomery, PLDI
    1994, fig. 4.1); the magic as the int32 of its bit pattern."""
    lg = (d - 1).bit_length()
    m = ((1 << 32) * ((1 << lg) - d)) // d + 1
    return (m - (1 << 32) if m >= 1 << 31 else m), min(lg, 1), max(lg - 1, 0)


def _plan_lib() -> ctypes.CDLL:
    lib = _build.load(PLAN_KERNEL)
    fn = lib.res_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.res_plan_error_string.argtypes = [ctypes.c_int]
        lib.res_plan_error_string.restype = ctypes.c_char_p
        lib.res_plan_host_counts.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p)]
        lib.res_plan_host_counts.restype = ctypes.c_int
    return lib


def _cause_counters(dev: torch.device):
    """(device counters, device address of their host copy) on ``dev``,
    made at the first plan there (not while a graph is captured: the
    graphed step runs each cadence eagerly first)."""
    if dev.index not in _card_causes:
        lib = _plan_lib()
        host, mapped = ctypes.c_void_p(), ctypes.c_void_p()
        rc = lib.res_plan_host_counts(len(CAUSES), ctypes.byref(host),
                                      ctypes.byref(mapped))
        if rc != 0:
            msg = lib.res_plan_error_string(rc).decode()
            raise RuntimeError(f"res_plan_host_counts failed: {msg} ({rc})")
        _card_causes[dev.index] = (
            torch.zeros(len(CAUSES), dtype=torch.int64, device=dev),
            mapped.value, (ctypes.c_int64 * len(CAUSES)).from_address(
                host.value))
    return _card_causes[dev.index][:2]


def _count_cause(pl: "Plan", ores: torch.Tensor):
    """A CPU plan's rebucket, if it decided one, under its cause, with
    tensor operations: the step reads nothing more on the host."""
    cause = torch.where(ores > 0, 0, torch.where(pl.overflow, 1, 2))
    _cpu_causes.index_add_(0, cause.view(1),
                           pl.rebuild.view(1).to(torch.int64))


def rebuckets_by_cause() -> dict:
    """{cause: rebuckets} that plans decided in this process, on every
    device, by ``CAUSES``.  On the card these are the mapped host copies
    as the device has written them so far: exact once its work is done
    (after a synchronize)."""
    out = _cpu_causes.tolist()
    for _, _, host in _card_causes.values():
        for k in range(len(CAUSES)):
            out[k] += host[k]
    return dict(zip(CAUSES, out))


def plan(sps: Sequence[SpeciesState], emits, obx: Outbox, ores, homes,
         spid, usable, g: Grid, inb: int = INB) -> Plan:
    """The residency step's exchange plan from the pushed lanes (``sps``,
    their emit marks, the push's outbox and its count ``ores`` of leavers
    past the outbox cap), the per-species block -> home brick maps and the
    static layout (``spid``, ``usable``: static_layout's).  The home maps
    are nondecreasing, as the brick sort makes them.

    CUDA tensors: four launches of csrc/res_plan.cu for every species
    (MAX_PLAN_SPECIES to a plan), bit for bit plan_ref, except that the
    compact rows past the routed total are left unwritten.  CPU tensors:
    the plain version.  Any other device raises.  A plan that decides a
    rebucket counts it under its cause (``rebuckets_by_cause``)."""
    global plan_launches
    nblk = _check_plan(sps, emits, obx, ores, homes, spid, usable)
    dev = obx.vox.device
    if dev.type == "cpu":
        out = plan_ref(sps, emits, obx, ores, homes, spid, usable, g, inb)
        _count_cause(out, ores)
        return out
    if dev.type != "cuda":
        raise ValueError(f"plan: unsupported device {dev}")
    have = [k for k, n in enumerate(nblk) if n]
    if len(have) > MAX_PLAN_SPECIES:
        raise NotImplementedError(f"plan: {len(have)} species with lanes, "
                                  f"the kernel takes {MAX_PLAN_SPECIES}")
    B = chart_dims(g)[0]
    if any(b & (b - 1) for b in B):
        raise NotImplementedError(f"plan: brick sides {B} are not powers "
                                  "of two")
    nbx, nby, _ = _nb(g)
    nb = nbricks(g)
    nblocks = sum(nblk)
    M = obx.vox.shape[0]
    out_cap = M // nblocks
    nkey = (int(np.max(spid)) + 1) * nb
    G = max(1, -(-nkey // out_cap), -(-nblocks // PLAN_TILES))
    ntiles = -(-nblocks // G)
    maxin = max_routed(nblocks, out_cap)
    ncompact = min(maxin, M)
    if M >= 2 ** 31 or nkey * ntiles >= 2 ** 31 or nkey * 4 > PLAN_SMEM:
        raise NotImplementedError(f"plan: {M} rows and {nkey} keys are "
                                  "past the kernel's int32 indices or its "
                                  "shared memory")
    ptrs, ints, j0 = [], [], 0
    for k, (sp, em, h) in enumerate(zip(sps, emits, homes)):
        if nblk[k]:
            # the lane pass loads 16 bytes of each at once
            for t, name in ((sp.live, f"species[{k}].live"),
                            (em, f"emits[{k}]"), (sp.i, f"species[{k}].i")):
                if t.data_ptr() % 16:
                    raise ValueError(f"{name} is not 16-byte aligned")
            ptrs += [sp.live.data_ptr(), em.data_ptr(), sp.i.data_ptr(),
                     h.data_ptr()]
            ints += [sp.capacity, nblk[k], j0, k]
        j0 += nblk[k]
    _, usable_t, _ = _static_tensors(spid, usable, dev)
    i32 = torch.int32
    scratch = torch.empty(nblocks + 3 * nkey + nkey * ntiles + M + 2,
                          dtype=i32, device=dev)
    cap, count, diff, hist, rank, first, total = torch.split(
        scratch, [nblocks, nkey, nkey, nkey * ntiles, M, nkey + 1, 1])
    mis = torch.empty(nblocks, dtype=torch.uint8, device=dev)
    sa = torch.empty((2, nblocks), dtype=i32, device=dev)
    compact = Outbox(
        f=torch.empty((7, ncompact), dtype=torch.float32, device=dev),
        vox=torch.empty(ncompact, dtype=i32, device=dev),
        valid=torch.empty(ncompact, dtype=torch.bool, device=dev))
    stats = torch.empty(2, dtype=torch.int64, device=dev)
    flags = torch.empty(3, dtype=torch.bool, device=dev)
    causes, causes_host = _cause_counters(dev)
    dims = [g.sy, g.sz, *_div_magic(g.sy), *_div_magic(g.sz),
            *(b.bit_length() - 1 for b in B), nbx, nby, nb, nkey, nblocks,
            out_cap, G, ntiles, M, inb, maxin, ncompact]
    bufs = [usable_t, obx.valid, obx.vox, obx.f, ores, cap, mis, count,
            hist, rank, first, diff, total, sa[0], sa[1], compact.f,
            compact.vox, compact.valid, stats, flags[0], flags[1], flags[2],
            causes]
    lib = _plan_lib()
    rc = lib.res_plan(
        len(have), c_array(ctypes.c_void_p, ptrs),
        c_array(ctypes.c_int, ints), c_array(ctypes.c_int, dims),
        c_array(ctypes.c_void_p, [t.data_ptr() for t in bufs]
                + [causes_host]),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.res_plan_error_string(rc).decode()
        raise RuntimeError(f"res_plan launch failed: {msg} ({rc})")
    plan_launches += PLAN_LAUNCHES
    return Plan(compact, sa[0], sa[1], flags[2], stats, flags[0], flags[1])


def _check_out(sps: Sequence[SpeciesState], out: Sequence[SpeciesState],
               block: int):
    if len(out) != len(sps):
        raise ValueError(f"merge_p: {len(out)} destination species for "
                         f"{len(sps)}")
    for k, (sp, o) in enumerate(zip(sps, out)):
        if sp.capacity % block:
            raise ValueError(f"species[{k}] capacity {sp.capacity} is not a "
                             f"multiple of {block}")
        if o.capacity != sp.capacity:
            raise ValueError(f"out[{k}] has {o.capacity} lanes, species[{k}] "
                             f"{sp.capacity}")


def merge_p_ref(sps: Sequence[SpeciesState], emits, compact: Outbox,
                starts_j, a_j, out: Sequence[SpeciesState],
                block: int = BLOCK) -> List[SpeciesState]:
    """Plain PyTorch version of merge_p, bit-identical to the JAX package's
    merge_p in every lane: per block, keepers (live, not emitted) first in
    lane order, then the block's newcomers, then zeros; a block with no
    keepers and no newcomers keeps its rows with live 0 and w 0 on dead
    lanes.  Moved floats get + 0.0 (merge_p's one-hot dots turn a -0.0 into
    +0.0).  Each species is computed whole, then copied into its
    destination, which may be its input."""
    _check_out(sps, out, block)
    dev = compact.vox.device
    i64 = torch.int64
    M = compact.vox.shape[0]
    lane = torch.arange(block, dtype=i64, device=dev)[None, :]
    # compact columns in order dx dy dz ux uy uz w, vox, with a zero column
    # for rows past the compact array
    cf = torch.cat([compact.f, torch.zeros((7, 1), dtype=torch.float32,
                                           device=dev)], 1)
    cv = torch.cat([compact.vox, torch.zeros(1, dtype=torch.int32,
                                             device=dev)])
    fnames = ("dx", "dy", "dz", "ux", "uy", "uz", "w")
    res, b0 = [], 0
    for sp, em, o in zip(sps, emits, out):
        N = sp.capacity
        nb = N // block
        live = sp.live.view(nb, block)
        keep = live & ~em.view(nb, block)
        ki = keep.to(i64)
        pos = torch.cumsum(ki, 1) - ki
        nk = ki.sum(1, keepdim=True)
        a = a_j[b0:b0 + nb].to(i64)[:, None]
        s = starts_j[b0:b0 + nb].to(i64)[:, None]
        ntot = nk + a
        # source lane of each keeper slot (lanes past nk read lane 0)
        src = torch.zeros((nb, block + 1), dtype=i64, device=dev)
        src.scatter_(1, torch.where(keep, pos, block),
                     lane.expand(nb, block).contiguous())
        src = src[:, :block]
        is_keep = lane < nk
        is_new = (lane >= nk) & (lane < ntot)
        c = s + (lane - nk)
        c = torch.where(is_new & (c >= 0) & (c < M), c, M)
        dead_blk = ntot == 0
        merged = {}
        for r, n in enumerate(fnames):
            x = getattr(sp, n).view(nb, block)
            moved = torch.where(is_keep, torch.gather(x, 1, src),
                                torch.where(is_new, cf[r][c], 0.0)) + 0.0
            if n == "w":
                x = torch.where(live, x, 0.0)
            merged[n] = torch.where(dead_blk, x, moved).reshape(N)
        x = sp.i.view(nb, block)
        moved = torch.where(is_keep, torch.gather(x, 1, src),
                            torch.where(is_new, cv[c], 0))
        merged["i"] = torch.where(dead_blk, x, moved).reshape(N)
        merged["live"] = (~dead_blk & (lane < ntot)).reshape(N)
        for n in LANE_FIELDS:
            getattr(o, n).copy_(merged[n])
        res.append(o.replace(np=merged["live"].sum(dtype=torch.int32)))
        b0 += nb
    return res


_ARGTYPES = ([ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
             + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 3)
WORDS = LANE_FIELDS[:-1]    # the kernel's lane words, in its pointer order


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.merge_p
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.merge_p_error_string.argtypes = [ctypes.c_int]
        lib.merge_p_error_string.restype = ctypes.c_char_p
    return lib


def _check_aligned(t: torch.Tensor, name: str):
    """The kernel loads 4 lanes at once: 16 bytes of a lane word, 4 of a
    mark."""
    if t.data_ptr() % (4 * t.element_size()):
        raise ValueError(f"{name} is not aligned to 4 lanes")


def _check_dest(src: torch.Tensor, dst: torch.Tensor, name: str):
    """A destination tensor is its (checked) input's memory, as the step
    merges, or a tensor of the same type and shape that lies apart from
    it."""
    a, b = src.data_ptr(), dst.data_ptr()
    if a == b and dst.dtype == src.dtype and dst.shape == src.shape \
            and dst.is_contiguous():
        return
    _check(dst, name, src.dtype, tuple(src.shape), src.device)
    n = src.numel() * src.element_size()
    if a < b + n and b < a + n:
        raise ValueError(f"{name} overlaps its input without being it")
    _check_aligned(dst, name)


def merge_p(sps: Sequence[SpeciesState], emits, compact: Outbox, starts_j,
            a_j, out: Sequence[SpeciesState],
            block: int = BLOCK) -> List[SpeciesState]:
    """Drop emitted lanes, compact each block's keepers in lane order and
    append the block's routed newcomers (block j takes compact rows
    [starts_j, starts_j + a_j)), writing species k into ``out[k]``'s
    tensors.  A destination tensor may be its input tensor (the step merges
    in place) or must lie apart from it.  Capacities must be multiples of
    ``block`` (the residency path works on extent slices).  Returns the
    destination species with their new ``np``.

    CUDA tensors: one launch of csrc/merge_p.cu for every species
    (MAX_SPECIES to a launch).  CPU tensors: the plain version.  Any other
    device raises."""
    global launches
    dev = sps[0].dx.device if sps else compact.vox.device
    if dev.type == "cpu":
        return merge_p_ref(sps, emits, compact, starts_j, a_j, out, block)
    if dev.type != "cuda":
        raise ValueError(f"merge_p: unsupported device {dev}")
    if block != BLOCK:
        raise ValueError(f"the merge kernel works on {BLOCK}-lane blocks")
    _check_out(sps, out, block)
    M = compact.vox.shape[0]
    _check(compact.f, "compact.f", torch.float32, (7, M), dev)
    _check(compact.vox, "compact.vox", torch.int32, (M,), dev)
    nblocks = []
    for k, (sp, em, o) in enumerate(zip(sps, emits, out)):
        N = sp.capacity
        nblocks.append(N // block)
        for n in LANE_FIELDS:
            dtype = (torch.bool if n == "live" else
                     torch.int32 if n == "i" else torch.float32)
            src = getattr(sp, n)
            _check(src, f"species[{k}].{n}", dtype, (N,), dev)
            _check_aligned(src, f"species[{k}].{n}")
            _check_dest(src, getattr(o, n), f"out[{k}].{n}")
        _check(em, f"emits[{k}]", torch.bool, (N,), dev)
        _check_aligned(em, f"emits[{k}]")
    total = sum(nblocks)
    _check(starts_j, "starts_j", torch.int32, (total,), dev)
    _check(a_j, "a_j", torch.int32, (total,), dev)

    lib = _kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nps = torch.zeros(len(sps), dtype=torch.int32, device=dev)
    j0 = [sum(nblocks[:k]) for k in range(len(sps))]
    for grp in species_groups(sps):
        ptrs = []
        for k in grp:
            sp, o = sps[k], out[k]
            ptrs += [getattr(sp, n).data_ptr() for n in WORDS]
            ptrs += [sp.live.data_ptr(), emits[k].data_ptr()]
            ptrs += [getattr(o, n).data_ptr() for n in WORDS]
            ptrs += [o.live.data_ptr(), nps[k:].data_ptr()]
        blk0, grid = launch_plan([nblocks[k] for k in grp])
        rc = lib.merge_p(
            len(grp), c_array(ctypes.c_void_p, ptrs),
            c_array(ctypes.c_int, blk0),
            c_array(ctypes.c_int, [j0[k] for k in grp]), grid,
            compact.f.data_ptr(), compact.vox.data_ptr(), M, M,
            starts_j.data_ptr(), a_j.data_ptr(), stream)
        if rc != 0:
            msg = lib.merge_p_error_string(rc).decode()
            raise RuntimeError(f"merge_p launch failed: {msg} ({rc})")
        launches += 1
    return [o.replace(np=nps[k]) for k, o in enumerate(out)]
