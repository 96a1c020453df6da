"""The 3-D push: the quantized brick sort with its block -> home-brick maps,
and the hand-written CUDA push kernel with the residency epilogue
(counterpart of ``vpic_tpu/ops/pallas_push3d.py``).

``fused_push3d_multi`` pushes every species of a 3-D deck.  On CUDA tensors
it launches ``csrc/fused_push3d.cu`` once for every species (each CUDA
block serves a run of consecutive 1024-lane layout blocks of one species
and deposits into its home brick's tile of the accumulator in shared
memory; the lane tensors are updated in place, and the rounds that take
the global path are counted in ``deposits``); on CPU tensors it runs the
plain version ``fused_push3d_multi_ref``
(``ops/push.advance_p`` per species, plus the residency epilogue in torch).
It never falls back from one to the other.  With ``residency`` it also
copies each block's brick-leavers into the block's outbox columns, which
``ops/residency`` routes and merges.

The brick layout is what the code computes, and it is ported faithfully:
8x8x8 bricks, the quantized brick sort (every 1024-lane block holds lanes of
one brick) with its exact home map, the slack blocks and the tight-packing
fallback.  One order differs: the residency path's relayout and rebucket
(``brick_sort_p_res``) deal each brick's lanes round-robin over its blocks,
where the JAX package fills them in order, so that the blocks on a brick's
faces do not hold its leavers alone; the home map is the same.  What the
JAX package computes only to fit the TPU has no counterpart here, because
the port keeps canonical voxels, the (nv, 18) ``load_interpolator`` table
and the (nv, 12) accumulator:

* the chart tables and their folds: ``to_chart_T`` (:136),
  ``fold_chart_acc`` (:167), ``_extend_axis``, ``chart_width``,
  ``interp.load_interpolator_T`` and ``pallas_push.fold_ghost_acc_T``;
* the h-major relayouts (:928-932) and the ``resident`` VMEM plan
  (:865-869) of ``_run3d``;
* ``_prefix_excl`` (:346): a block scan of warp ballots takes its place;
  the hi/lo one-hot dots and ``dep_terms``;
* the chart-exit pre-flag and the quantile home fallback: the kernel walks
  canonical voxels and reaches any cell, so no lane is ever flagged;
* the wall pre-flag and the region mark (:550-590) and the outlier replay
  they feed: as in 2-D (``ops/fused_push.py``), the kernel's WALLS
  instance applies the absorbing, custom and per-voxel-face rules where the
  walk meets them, given a ``push.Walls``.  A lane that died or was parked
  at a wall is not a brick-leaver: it never reaches the outbox, and
  ``boundary_p`` handles it before the exchange, as the JAX package's
  replay runs before it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..grid import Grid
from ..state import SpeciesState
from . import _build
from .fused_push import (GRID_ARGTYPES, TABLE_ARGTYPES, WALL_ARGTYPES,
                         _check, _round_up, c_array, c_species_table,
                         check_walls, deposit_counter, launch_plan,
                         packed_src_sort, push_constants, push_species_ref,
                         recount, species_groups, wall_constants,
                         wall_outputs)
from .push import CUSTOM_BASE, Walls, check_particle_bcs, gather_sp_rows

B3 = 8                      # 3-D brick side (cells)
CH2_B = (16, 8, 1)          # 2-D brick dims (x, y, z cells)
CH2_HALO = 8                # 2-D halo depth
BLOCK = 1024                # lanes per layout block (= the sort quantum)
OUT_CAP = 128               # outbox columns per block
KERNEL = "fused_push3d"
LANE_FIELDS = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live")
WAVES = 2                   # the kernel's grid: at most this many waves
                            # of the resident blocks (1, 2 and 4 time alike)

# Kernel launches made by fused_push3d_multi since the count was last reset.
launches = 0
# Deposit rounds of those launches, on the card: [taken the global path,
# all].  None until the first launch; set it to None to reset the count.
deposits = None


class Outbox(NamedTuple):
    """Particle rows in SoA, one column per row: the push's per-block
    outboxes (``OUT_CAP`` columns per block, concatenated over species in
    launch block order) or plan_exchange's destination-sorted compact rows.
    The JAX package's (9, M) f32 matrix holds the same: rows dx dy dz, the
    voxel, ux uy uz w, and the valid mark."""
    f: torch.Tensor       # (7, M) float32: dx dy dz ux uy uz w
    vox: torch.Tensor     # (M,) int32
    valid: torch.Tensor   # (M,) bool


def chart_dims(g: Grid):
    """Per-axis brick geometry: (brick B, halo H, chart C, padded lane count
    S, used lanes), as the JAX package defines it.  3-D grids tile 8^3
    bricks; 2-D (nz == 1) grids 16x8 bricks."""
    if g.nz > 1:
        B = (B3, B3, B3)
        HAL = (1, 1, 1)
    else:
        B = CH2_B
        HAL = (CH2_HALO, CH2_HALO, 0)
    C = tuple(b + 2 * h if n > 1 else 1
              for b, h, n in zip(B, HAL, (g.nx, g.ny, g.nz)))
    used = C[0] * C[1] * C[2]
    S = _round_up(used, 128)
    return B, HAL, C, S, used


def supports3d(g: Grid, max_capacity: int = 0) -> bool:
    """Bricks need every axis divisible by the brick side and at least one
    full chart per axis, int32 lane indices, and voxel indices below 2^24
    (the JAX package's rule, kept so both packages take the same decks)."""
    B, HAL, C, S, used = chart_dims(g)
    for n, b, c in zip((g.nx, g.ny, g.nz), B, C):
        if n <= 1 and b == 1:
            continue
        if n % b or n < c:
            return False
    if max_capacity and max_capacity >= (1 << 30):
        return False
    return 1024 <= g.nv < (1 << 24)


def check3d(g: Grid, max_capacity: int = 0, bricks: bool = True) -> None:
    """Raise for 3-D decks the 3-D kernel cannot push: nz > 1, faces a
    walk can serve (push.check_particle_bcs), int32 lane and voxel
    indices, and with ``bricks`` (a home map or the residency outbox) the
    brick rule of supports3d.  Without home maps the kernel walks any
    grid, every deposit on the global path: the deck's general path
    pushes the grids the bricks do not tile so."""
    if g.nz <= 1:
        raise ValueError(f"nz={g.nz}: the 3-D path needs nz > 1")
    if bricks and not supports3d(g, max_capacity):
        raise NotImplementedError(
            f"grid {g.nx}x{g.ny}x{g.nz}: the brick path needs every axis a "
            "multiple of 8 cells and at least 16, and 1024 <= nv < 2^24; "
            "other 3-D grids take the general push path, without home maps")
    if max_capacity >= (1 << 30) or g.nv >= (1 << 31):
        raise NotImplementedError(
            f"capacity {max_capacity}, nv {g.nv}: the 3-D kernel indexes "
            "lanes and voxels with int32")
    check_particle_bcs(g)


def _nb(g: Grid) -> Tuple[int, int, int]:
    B = chart_dims(g)[0]
    return g.nx // B[0], g.ny // B[1], max(g.nz // B[2], 1)


def nbricks(g: Grid) -> int:
    nbx, nby, nbz = _nb(g)
    return nbx * nby * nbz


def _fdiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def brick_of(i: torch.Tensor, g: Grid) -> torch.Tensor:
    """Canonical voxel -> home brick id (live-lane use only)."""
    B = chart_dims(g)[0]
    nbx, nby, nbz = _nb(g)
    zi = _fdiv(i, g.sz)
    r = i - zi * g.sz
    yi = _fdiv(r, g.sy)
    xi = r - yi * g.sy
    return (_fdiv(xi - 1, B[0])
            + nbx * (_fdiv(yi - 1, B[1]) + nby * _fdiv(zi - 1, B[2])))


def _sort_src_q(b: torch.Tensor, nb: int, N: int, quantum: int,
                nhome: int = 0, slack: int = 0, interleave: bool = False):
    """Per-output-slot source index of the quantized brick sort (-1 for gap
    and dead slots) and the (max(ceil(N/quantum), nhome),) block -> home
    brick map the layout implies; bit-equal to the JAX package's.  Each
    brick's slots are rounded up to whole blocks plus ``slack`` empty ones;
    when that overflows N the layout falls back to tight packing, where a
    block's home is the brick of its first slot.  ``interleave`` deals a
    brick's sorted lanes round-robin over its nfull = ceil(lanes/quantum)
    blocks in the quantized layout (sorted lane r to block r mod nfull,
    column r div nfull), so each block holds a near-equal share of every
    voxel of the brick; the home map and the tight packing stay as they
    are, and a brick of one block is laid out as without it."""
    dev = b.device
    i64 = lambda t: t.to(torch.int64)
    b_sorted, sorted_src = packed_src_sort(b, N, nb + 1)
    b_sorted = i64(b_sorted)
    sorted_src = i64(sorted_src)
    seg_start = torch.searchsorted(
        b_sorted, torch.arange(nb + 1, dtype=torch.int64, device=dev))
    totb = seg_start[1:] - seg_start[:-1]                     # (nb,)
    nfull = _fdiv(totb + quantum - 1, quantum)                # lane blocks
    totq = (nfull + slack) * quantum
    qend = torch.cumsum(totq, 0)
    qoff = qend - totq
    ok = qend[-1] <= N

    nblk = max((N + quantum - 1) // quantum, nhome)
    blk0 = torch.arange(nblk, dtype=torch.int64, device=dev) * quantum
    k = torch.clamp(torch.searchsorted(qend, blk0, right=True), 0, nb - 1)
    lane = torch.arange(quantum, dtype=torch.int64, device=dev)[None, :]
    if interleave:
        # in place: one (nblk, quantum) index grid, as the other branch
        nf = nfull[k]
        m = _fdiv(blk0 - qoff[k], quantum)                    # block in brick
        idx = lane * torch.clamp(nf, min=1)[:, None]
        idx += m[:, None]                                     # rank in brick
        live = idx < totb[k][:, None]
        live &= (m < nf)[:, None]
        idx += seg_start[k][:, None]
        idx.clamp_(0, max(N - 1, 0))
    else:
        start_j = blk0 + seg_start[k] - qoff[k]               # first source
        rem = torch.clamp(totb[k] - (blk0 - qoff[k]), 0, quantum)
        live = lane < rem[:, None]                            # live in blk
        idx = torch.clamp(start_j[:, None] + lane, 0, max(N - 1, 0))
    q_src = torch.where(live, sorted_src[idx], -1).reshape(-1)[:N]

    n_live = seg_start[nb]
    t_src = torch.where(torch.arange(N, device=dev) < n_live, sorted_src, -1)
    t_home = torch.clamp(b_sorted[torch.clamp(blk0, 0, N - 1)], 0, nb - 1)
    home = torch.where(ok, k, t_home).to(torch.int32)
    return torch.where(ok, q_src, t_src), home


def brick_sort_p_home(sp: SpeciesState, g: Grid, quantum: int = BLOCK,
                      extent: int = 0, slack: int = 0):
    """Counting sort by home brick with each brick's slot range rounded up
    to whole blocks (every block holds one brick's lanes), plus ``slack``
    empty blocks per brick for residency.  Returns (sorted species, the
    (ceil(capacity/quantum),) int32 block -> home brick map).  Dead lanes
    are dropped and pad slots come back dead with w = 0, bit-equal to the
    JAX package (a pad slot keeps slot 0's other columns).  ``extent``
    bounds the live slots (see bucket_sort_p): only the first
    round_up(extent + nbricks*(1+slack)*quantum, quantum) slots are sorted.
    Returns new tensors."""
    return _brick_sort(sp, g, quantum, extent, slack, False)


def brick_sort_p_res(sp: SpeciesState, g: Grid, extent: int = 0,
                     slack: int = 0):
    """The residency path's brick sort (the relayout and the rebucket):
    brick_sort_p_home's block -> home map, live lanes per brick and slack
    blocks, with each brick's lanes dealt round-robin over its blocks
    (``_sort_src_q``'s ``interleave``).  A block then holds a near-equal
    share of every voxel of its brick, not a run of neighbouring voxels,
    so the blocks on a brick's faces do not hold its leavers alone and
    overflow their outboxes.  Where every brick fits one block, or the
    layout falls back to tight packing, it is brick_sort_p_home."""
    return _brick_sort(sp, g, BLOCK, extent, slack, True)


def _brick_sort(sp: SpeciesState, g: Grid, quantum: int, extent: int,
                slack: int, interleave: bool):
    N = sp.capacity
    nb = nbricks(g)
    E = (min(_round_up(extent + nb * (1 + slack) * quantum, quantum), N)
         if extent else N)
    head = sp.replace(**{n: getattr(sp, n)[:E] for n in LANE_FIELDS})
    b = torch.where(head.live, brick_of(head.i, g), nb)
    src, home = _sort_src_q(b, nb, E, quantum,
                            nhome=(N + quantum - 1) // quantum, slack=slack,
                            interleave=interleave)
    moved = gather_sp_rows(torch.clamp(src, min=0), head)
    moved["live"] = moved["live"] & (src >= 0)
    moved["w"] = torch.where(moved["live"], moved["w"], 0.0)
    if E < N:
        tail = {n: getattr(sp, n)[E:] for n in LANE_FIELDS}
        tail["w"] = torch.where(tail["live"], tail["w"], 0.0)
        tail["live"] = torch.zeros_like(tail["live"])
        moved = {n: torch.cat([moved[n], tail[n]]) for n in LANE_FIELDS}
    return sp.replace(**moved), home


def brick_sort_p(sp: SpeciesState, g: Grid, quantum: int = BLOCK,
                 extent: int = 0) -> SpeciesState:
    """brick_sort_p_home without the home map."""
    return brick_sort_p_home(sp, g, quantum, extent)[0]


def _residency_epilogue(out: Sequence[SpeciesState], homes, g: Grid,
                        out_cap: int, pends=None):
    """The kernel's residency epilogue in torch: a pushed live lane whose
    voxel left its block's home brick is a leaver, unless it is parked at a
    custom face (``pends``); the first ``out_cap`` of each block, in lane
    order, go to the block's outbox columns and get their emit mark.
    Returns (emits, outbox, ores)."""
    dev = out[0].dx.device
    nblocks = [(sp.capacity + BLOCK - 1) // BLOCK for sp in out]
    M = sum(nblocks) * out_cap
    obx_f = torch.zeros((7, M + 1), dtype=torch.float32, device=dev)
    obx_vox = torch.zeros((M + 1,), dtype=torch.int32, device=dev)
    valid = []
    emits = []
    ores = torch.zeros((), dtype=torch.int32, device=dev)
    blk0 = 0
    for k, (sp, home, nb) in enumerate(zip(out, homes, nblocks)):
        N = sp.capacity
        pad = nb * BLOCK - N
        hl = home.to(torch.int64).repeat_interleave(BLOCK)[:N]
        leave = sp.live & (brick_of(sp.i, g).to(torch.int64) != hl)
        if pends is not None:
            leave = leave & (pends[k] < CUSTOM_BASE)
        lv = torch.nn.functional.pad(leave, (0, pad)).view(nb, BLOCK)
        li = lv.to(torch.int32)
        pos = torch.cumsum(li, 1, dtype=torch.int32) - li
        em = lv & (pos < out_cap)
        ores = ores + (lv & ~em).sum(dtype=torch.int32)
        nem = em.sum(1)
        col = ((blk0 + torch.arange(nb, device=dev))[:, None] * out_cap
               + pos.to(torch.int64))
        dest = torch.where(em, col, M).reshape(-1)
        vals = torch.stack([sp.dx, sp.dy, sp.dz, sp.ux, sp.uy, sp.uz, sp.w])
        obx_f.index_copy_(1, dest,
                          torch.nn.functional.pad(vals, (0, pad)))
        obx_vox.index_copy_(0, dest, torch.nn.functional.pad(sp.i, (0, pad)))
        c = torch.arange(out_cap, device=dev)
        valid.append((c[None, :] < nem[:, None]).reshape(-1))
        emits.append(em.reshape(-1)[:N])
        blk0 += nb
    obx = Outbox(f=obx_f[:, :M].contiguous(), vox=obx_vox[:M].contiguous(),
                 valid=torch.cat(valid))
    return emits, obx, ores


def fused_push3d_multi_ref(species: Sequence[SpeciesState], fcoef, acc,
                           g: Grid, qms, homes=None, max_streak: int = 4,
                           residency: bool = False, out_cap: int = OUT_CAP,
                           walls: Walls = None):
    """Plain PyTorch version of fused_push3d_multi: advance_p per species
    into the shared accumulator, then (``residency``) the outbox epilogue.
    Returns (species, acc, emits, outbox, ores, unfinished) like the kernel
    path, with new species tensors; emits, outbox and ores are None without
    residency."""
    check3d(g, bricks=homes is not None or residency)
    check_walls(g, walls, acc.device)
    results, unfinished = push_species_ref(species, fcoef, acc, g, qms,
                                           max_streak, walls)
    out = []
    for sp, res in zip(species, results):
        # dead lanes pass through untouched, as in the kernel
        # (advance_p moves every lane's momentum and zeroes dead weights)
        new = res.species
        out.append(new.replace(
            **{n: torch.where(sp.live, getattr(new, n), getattr(sp, n))
               for n in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w")}))
    if not residency:
        return out, acc, None, None, None, unfinished
    if homes is None:
        raise ValueError("residency needs the home maps")
    emits, obx, ores = _residency_epilogue(
        out, homes, g, out_cap, None if walls is None else walls.pends)
    return out, acc, emits, obx, ores, unfinished


def run_length(nblocks: int, slots: int) -> int:
    """Layout blocks per CUDA block: the fewest that keep a launch of
    ``nblocks`` layout blocks within WAVES waves of ``slots`` resident CUDA
    blocks (SMs x blocks per SM).  Longer runs flush their tiles fewer
    times; the waves keep every SM busy to the end."""
    if slots < 1:
        raise ValueError(f"slots={slots} must be at least 1")
    return max(1, -(-nblocks // (WAVES * slots)))


_ARGTYPES = (TABLE_ARGTYPES + [ctypes.POINTER(ctypes.c_int)]
             + [ctypes.POINTER(ctypes.c_float)] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 4 + GRID_ARGTYPES + [ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p]
             + [ctypes.c_int] + WALL_ARGTYPES + [ctypes.c_void_p])
_slots = {}                 # device index -> resident CUDA blocks


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.fused_push3d
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.fused_push3d_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.fused_push3d_blocks_per_sm.restype = ctypes.c_int
        lib.fused_push3d_error_string.argtypes = [ctypes.c_int]
        lib.fused_push3d_error_string.restype = ctypes.c_char_p
    return lib


def resident_blocks(dev: torch.device, walls: bool = False) -> int:
    """CUDA blocks of the kernel (its WALLS instance if ``walls``) the card
    holds at once."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if (idx, walls) not in _slots:
        with torch.cuda.device(idx):
            per_sm = _kernel_lib().fused_push3d_blocks_per_sm(int(walls))
        if per_sm < 1:
            raise RuntimeError("fused_push3d: no block of the kernel fits "
                               "on an SM")
        _slots[idx, walls] = per_sm * torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _slots[idx, walls]


def fused_push3d_multi(species: Sequence[SpeciesState], fcoef: torch.Tensor,
                       acc: torch.Tensor, g: Grid,
                       qms: Sequence[Tuple[float, float]],
                       homes: Optional[Sequence[torch.Tensor]] = None,
                       max_streak: int = 4, residency: bool = False,
                       out_cap: int = OUT_CAP, walls: Walls = None):
    """Push every species of a 3-D deck one step and deposit their currents.

    ``fcoef`` is the (nv, 18) load_interpolator table, ``acc`` the (nv, 12)
    float32 accumulator (added to in place), ``qms`` (charge, mass) per
    species, ``homes`` the per-species (ceil(capacity/1024),) int32 block ->
    home brick maps of the last brick sort (needed with ``residency``;
    without them every deposit takes the global path, and the grid need
    not be one the bricks tile), ``walls`` the
    push.Walls a deck with wall faces needs (its rhob is added to in place,
    and its pends / disps are set for the lanes live when the push
    began).

    Returns (species, acc, emits, outbox, ores, unfinished): per-species
    bool emit marks (a lane copied to its block's outbox), the Outbox
    (``out_cap`` columns per block, concatenated over species), the 0-d
    int32 count of leavers past the cap, and the 0-d int32 count of lanes
    still walking after ``max_streak`` rounds.  Without ``residency`` emits,
    outbox and ores are None.

    CUDA tensors: one kernel launch for every species (MAX_SPECIES to a
    launch); the species tensors are updated IN PLACE and the same objects
    are returned (with walls, with ``np`` recounted), and the module's
    ``deposits`` counts the launch's deposit rounds on the card.  CPU
    tensors: the plain version, which returns new tensors.  Any other
    device raises."""
    global launches, deposits
    check3d(g, max((sp.capacity for sp in species), default=0),
            bricks=homes is not None or residency)
    dev = fcoef.device
    if dev.type == "cpu":
        return fused_push3d_multi_ref(species, fcoef, acc, g, qms, homes,
                                      max_streak, residency, out_cap, walls)
    if dev.type != "cuda":
        raise ValueError(f"fused_push3d_multi: unsupported device {dev}")
    check_walls(g, walls, dev)
    if len(species) != len(qms):
        raise ValueError("one (charge, mass) pair per species")
    if not 0 < out_cap <= BLOCK:
        raise ValueError(f"out_cap={out_cap} must be in (0, {BLOCK}]")
    _check(fcoef, "fcoef", torch.float32, (g.nv, 18), dev)
    _check(acc, "acc", torch.float32, (g.nv, 12), dev)
    if residency and (homes is None or len(homes) != len(species)):
        raise ValueError("residency needs one home map per species")
    nblocks = [(sp.capacity + BLOCK - 1) // BLOCK for sp in species]
    for k, sp in enumerate(species):
        n = sp.capacity
        for name in ("dx", "dy", "dz", "ux", "uy", "uz", "w"):
            _check(getattr(sp, name), f"species[{k}].{name}", torch.float32,
                   (n,), dev)
        _check(sp.i, f"species[{k}].i", torch.int32, (n,), dev)
        _check(sp.live, f"species[{k}].live", torch.bool, (n,), dev)
        if homes is not None:
            _check(homes[k], f"homes[{k}]", torch.int32, (nblocks[k],), dev)

    lib = _kernel_lib()
    unfinished = torch.zeros((1,), dtype=torch.int32, device=dev)
    deposits = deposit_counter(deposits, dev)
    emits = obx = ores = None
    M = sum(nblocks) * out_cap
    if residency:
        obx = Outbox(f=torch.empty((7, M), dtype=torch.float32, device=dev),
                     vox=torch.empty((M,), dtype=torch.int32, device=dev),
                     valid=torch.empty((M,), dtype=torch.bool, device=dev))
        ores = torch.zeros((1,), dtype=torch.int32, device=dev)
        emits = [torch.empty((sp.capacity,), dtype=torch.bool, device=dev)
                 for sp in species]
    stream = torch.cuda.current_stream(dev).cuda_stream
    col0 = [sum(nblocks[:k]) * out_cap for k in range(len(species))]
    res = ([obx.f.data_ptr(), obx.vox.data_ptr(), obx.valid.data_ptr(), M,
            ores.data_ptr()] if residency else [None, None, None, M, None])
    slots = resident_blocks(dev, walls is not None)
    pends, disps = wall_outputs(species, walls)
    for grp in species_groups(species):
        sps = [species[k] for k in grp]
        pick = lambda ts: None if ts is None else [ts[k] for k in grp]
        ptrs, n, qdt_2mc, qsp, qr8v = c_species_table(
            sps, [qms[k] for k in grp], g, homes=pick(homes),
            emits=pick(emits), pends=pick(pends), disps=pick(disps))
        run = run_length(sum(nblocks[k] for k in grp), slots)
        blk0, grid = launch_plan([nblocks[k] for k in grp], run)
        rc = lib.fused_push3d(
            len(sps), ptrs, n, c_array(ctypes.c_int, blk0),
            c_array(ctypes.c_int, [col0[k] for k in grp]), qdt_2mc, qsp,
            qr8v, grid, run, fcoef.data_ptr(), acc.data_ptr(),
            unfinished.data_ptr(), deposits.data_ptr(), *push_constants(g),
            max_streak, int(residency), *res, out_cap,
            *wall_constants(g, walls), stream)
        if rc != 0:
            msg = lib.fused_push3d_error_string(rc).decode()
            raise RuntimeError(f"fused_push3d launch failed: {msg} ({rc})")
        launches += 1
    return (recount(species, walls), acc, emits, obx,
            ores[0] if residency else None, unfinished[0])
