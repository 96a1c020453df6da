"""The main path's particle push: bucket sort plus the hand-written CUDA push
kernel (counterpart of ``vpic_tpu/ops/pallas_push.py``).

``fused_push_multi`` pushes every species and deposits their currents into
one (nv, 12) accumulator.  On CUDA tensors it launches
``csrc/fused_push2d.cu`` once for every species (on the current stream; the
particle tensors are updated in place): each CUDA block takes LANES lanes of
one species and deposits into a tile of the accumulator in shared memory,
and the rounds whose voxel lies outside the tile take the global path,
counted in ``deposits``.  On CPU tensors it runs the plain version
``fused_push_multi_ref`` (``ops/push.advance_p`` per species).  It never
falls back from one to the other.

The kernel works in canonical voxels and wraps periodic faces itself, so
none of the TPU kernel's voxel windows, ghost residents or outlier replay
exist here.  On a deck with wall faces (absorbing or custom domain faces,
or a per-voxel-face table; ``ops/push.has_walls``) the caller passes a
``push.Walls``: the kernel's WALLS instance then kills lanes at absorbing
faces (their charge into ``walls.rhob``), parks lanes at custom faces and
writes every lane's pend code and remaining displacement for
``boundary.boundary_p``, as the general path's advance_p does.  On a
decomposed grid a rank's remote faces are wall faces too: the WALLS
instance parks a lane that reaches one with pend = face for the migration
rounds (``push.particle_bcs`` gives the kernel the rank's face codes).
Without wall faces the launch runs the instance that has none of that
code.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..grid import P_PERIODIC, Grid
from ..state import SpeciesState
from . import _build
from .push import (UNFINISHED, Walls, advance_p, check_particle_bcs,
                   gather_sp_rows, has_walls, particle_bcs)

BUCKET = 128
KERNEL = "fused_push2d"
LANES = 1024                # lanes (and threads) per CUDA block of the kernel
MAX_SPECIES = 8             # species one launch takes (the kernel's table)

# Kernel launches made by fused_push_multi since the count was last reset.
launches = 0
# Deposit rounds of those launches, on the card: [taken the global path,
# all].  None until the first launch; set it to None to reset the count.
deposits = None


def supports(g: Grid) -> bool:
    """True when the push kernel can run this grid; raises otherwise
    (2-D, and faces a walk can serve: push.check_particle_bcs)."""
    if g.nz != 1:
        raise NotImplementedError(
            f"nz={g.nz}: the fused push covers 2-D grids (nz == 1); 3-D "
            "decks come with the 3-D slice")
    check_particle_bcs(g)
    return True


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def packed_src_sort(b: torch.Tensor, rows: int, nkeys: int):
    """Stable sort of ``rows`` lanes by small key ``b`` (values < nkeys);
    returns (b_sorted, src) with src the per-output-slot SOURCE index
    (int32).  The JAX package packs (key, slot) into one uint32 so its sort
    is stable for free; a stable torch.sort gives the same order, since the
    slot suffix there breaks ties in slot order."""
    if b.shape[0] != rows:
        raise ValueError(f"{b.shape[0]} keys for {rows} rows")
    b_sorted, src = torch.sort(b, stable=True)
    return b_sorted, src.to(torch.int32)


def bucket_sort_p(sp: SpeciesState, g: Grid, bucket: int = BUCKET,
                  extent: int = 0) -> SpeciesState:
    """Stable sort of the lanes by voxel bucket (i // bucket), live lanes
    first.  ``extent`` bounds the live slots (the deck passes its injection
    count when nothing can grow the live set): only the first
    round_up(extent, 1024) slots are sorted and the dead tail is left as
    it is.  Returns new tensors; dead lanes come back with voxel 0."""
    N = sp.capacity
    E = min(_round_up(extent, 1024), N) if extent else N
    nb = _round_up(g.nv, bucket) // bucket
    head = sp.replace(**{n: getattr(sp, n)[:E] for n in
                         ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w",
                          "live")})
    key = torch.where(head.live, torch.div(head.i, bucket,
                                           rounding_mode="floor"), nb)
    _, src = packed_src_sort(key, E, nb + 1)
    moved = gather_sp_rows(src.long(), head)
    if E < N:
        moved = {n: torch.cat([m, getattr(sp, n)[E:]])
                 for n, m in moved.items()}
    return sp.replace(**moved)


def check_walls(g: Grid, walls, dev: torch.device):
    """Raise unless ``walls`` is what a push on ``g`` needs: a Walls on a
    deck with wall faces (see push.has_walls), with a flat (nv,) float32
    rhob and an (nv, 6) int32 vbc table or None on ``dev``."""
    if walls is None:
        if has_walls(g):
            raise ValueError("the grid has absorbing or custom particle "
                             "faces: pass walls=Walls(rhob, vbc)")
        return
    _check(walls.rhob, "walls.rhob", torch.float32, (g.nv,), dev)
    if walls.vbc is not None:
        _check(walls.vbc, "walls.vbc", torch.int32, (g.nv, 6), dev)


def push_species_ref(species: Sequence[SpeciesState], fcoef, acc, g: Grid,
                     qms, max_streak: int = 4, walls=None):
    """advance_p per species into the shared accumulator (and walls.rhob),
    filling walls.pends / walls.disps as the kernels do for the lanes live
    when the push began (and pend DONE, displacement 0 on the others, which
    the kernels leave unwritten).  Returns (the advance_p results,
    unfinished)."""
    rhob = vbc = None
    if walls is not None:
        rhob, vbc = walls.rhob, walls.vbc
        walls.pends, walls.disps = [], []
    results = []
    unfinished = torch.zeros((), dtype=torch.int32, device=acc.device)
    for sp, (q, m) in zip(species, qms):
        res = advance_p(sp, fcoef, g, q, m, acc, rhob, max_streak=max_streak,
                        vbc=vbc)
        results.append(res)
        unfinished = unfinished + (res.pend_face == UNFINISHED).sum(
            dtype=torch.int32)
        if walls is not None:
            walls.pends.append(res.pend_face)
            walls.disps.append(torch.where(sp.live, torch.stack(res.pend_disp),
                                           0.0))
    return results, unfinished


def fused_push_multi_ref(species: Sequence[SpeciesState], fcoef, acc,
                         g: Grid, qms, max_streak: int = 4, walls=None):
    """Plain PyTorch version of fused_push_multi: advance_p per species into
    the shared accumulator.  Returns (species, acc, unfinished) like the
    kernel path, with new species tensors."""
    supports(g)
    check_walls(g, walls, acc.device)
    results, unfinished = push_species_ref(species, fcoef, acc, g, qms,
                                           max_streak, walls)
    return [r.species for r in results], acc, unfinished


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def launch_plan(blocks: Sequence[int], run: int = 1) -> Tuple[List[int], int]:
    """(blk0, grid) of one launch: species k's ``blocks[k]`` lane blocks
    are served by ceil(blocks[k] / run) CUDA blocks, species after species,
    so no CUDA block holds lanes of two species; blk0[k] is species k's
    first CUDA block and grid the launch's count."""
    if run < 1:
        raise ValueError(f"run={run} must be at least 1")
    blk0, grid = [], 0
    for nb in blocks:
        blk0.append(grid)
        grid += -(-nb // run)
    return blk0, grid


def species_groups(species: Sequence[SpeciesState]) -> List[List[int]]:
    """The indices of the species with lanes, MAX_SPECIES to a launch."""
    todo = [k for k, sp in enumerate(species) if sp.capacity]
    return [todo[j:j + MAX_SPECIES] for j in range(0, len(todo), MAX_SPECIES)]


def c_array(ctype, values):
    return (ctype * len(values))(*values)


def c_species_table(species: Sequence[SpeciesState], qms, g: Grid,
                    homes=None, emits=None, pends=None, disps=None):
    """The entry points' per-species host arrays for one launch: the 13
    pointers per species (dx dy dz vox ux uy uz w live home emit pend
    pdisp; each of the last four null when not given), the lane counts,
    qdt_2mc, qsp and qsp * r8V."""
    opt = lambda ts, k: None if ts is None else ts[k].data_ptr()
    ptrs = []
    for k, sp in enumerate(species):
        ptrs += [t.data_ptr() for t in (sp.dx, sp.dy, sp.dz, sp.i, sp.ux,
                                        sp.uy, sp.uz, sp.w, sp.live)]
        ptrs += [opt(homes, k), opt(emits, k), opt(pends, k), opt(disps, k)]
    return (c_array(ctypes.c_void_p, ptrs),
            c_array(ctypes.c_int, [sp.capacity for sp in species]),
            c_array(ctypes.c_float,
                    [(q * g.dt) / (2.0 * m * g.cvac) for q, m in qms]),
            c_array(ctypes.c_float, [q for q, _ in qms]),
            c_array(ctypes.c_float, [q * g.r8V for q, _ in qms]))


def push_constants(g: Grid):
    """The entry points' grid arguments: cdt_dx, cdt_dy, cdt_dz, nx, ny,
    nz, and whether each axis' particle faces are periodic."""
    bcs = particle_bcs(g)
    periodic = [int(bcs[ax] == P_PERIODIC) for ax in range(3)]
    return (g.cvac * g.dt * g.rdx, g.cvac * g.dt * g.rdy,
            g.cvac * g.dt * g.rdz, g.nx, g.ny, g.nz, *periodic)


def wall_constants(g: Grid, walls):
    """The entry points' wall arguments: walls (0/1), this rank's six
    particle face codes, the vbc table and rhob (null without walls)."""
    if walls is None:
        return (0, c_array(ctypes.c_int, [0] * 6), None, None)
    return (1, c_array(ctypes.c_int, list(particle_bcs(g))),
            None if walls.vbc is None else walls.vbc.data_ptr(),
            walls.rhob.data_ptr())


def recount(species: Sequence[SpeciesState], walls) -> List[SpeciesState]:
    """The species after a kernel push: with walls, lanes may have died at
    an absorbing face, so ``np`` counts the live lanes anew (a device
    reduction, no host read); without, the same objects."""
    if walls is None:
        return list(species)
    return [sp.replace(np=sp.live.sum(dtype=torch.int32)) for sp in species]


def wall_outputs(species: Sequence[SpeciesState], walls):
    """Fresh walls.pends / walls.disps for the kernel to write (the lanes
    live when the push begins; the other slots stay unwritten), or (None,
    None) without walls."""
    if walls is None:
        return None, None
    walls.pends = [torch.empty((sp.capacity,), dtype=torch.int32,
                               device=sp.dx.device) for sp in species]
    walls.disps = [torch.empty((3, sp.capacity), dtype=torch.float32,
                               device=sp.dx.device) for sp in species]
    return walls.pends, walls.disps


def deposit_counter(count, dev: torch.device) -> torch.Tensor:
    """``count`` when it is a deposit count on ``dev``, else a new one."""
    if count is None or count.device != dev:
        count = torch.zeros(2, dtype=torch.int64, device=dev)
    return count


TABLE_ARGTYPES = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                  ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
GRID_ARGTYPES = [ctypes.c_float] * 3 + [ctypes.c_int] * 7
WALL_ARGTYPES = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)] \
    + [ctypes.c_void_p] * 2
_ARGTYPES = (TABLE_ARGTYPES + [ctypes.POINTER(ctypes.c_float)] * 3
             + [ctypes.c_int] + [ctypes.c_void_p] * 4 + GRID_ARGTYPES
             + WALL_ARGTYPES + [ctypes.c_void_p])


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.fused_push2d
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.fused_push2d_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.fused_push2d_blocks_per_sm.restype = ctypes.c_int
        lib.fused_push2d_error_string.argtypes = [ctypes.c_int]
        lib.fused_push2d_error_string.restype = ctypes.c_char_p
    return lib


def fused_push_multi(species: Sequence[SpeciesState], fcoef: torch.Tensor,
                     acc: torch.Tensor, g: Grid,
                     qms: Sequence[Tuple[float, float]],
                     max_streak: int = 4, walls: Walls = None
                     ) -> Tuple[List[SpeciesState], torch.Tensor,
                                torch.Tensor]:
    """Push every species one step and deposit their currents.

    ``fcoef`` is the (nv, 18) load_interpolator table, ``acc`` the (nv, 12)
    float32 accumulator (added to in place), ``qms`` (charge, mass) per
    species, ``walls`` the push.Walls a deck with wall faces needs (its
    rhob is added to in place, and its pends / disps are set for the lanes
    live when the push began).  Returns
    (species, acc, unfinished), where ``unfinished`` is a 0-d int32 device
    tensor counting lanes still walking after ``max_streak`` rounds.

    CUDA tensors: one kernel launch for every species (MAX_SPECIES to a
    launch); the species tensors are updated IN PLACE and the same objects
    are returned (with walls, with ``np`` recounted), and the module's
    ``deposits`` counts the launch's deposit rounds on the card.  CPU
    tensors: the plain version, which returns new tensors.  Any other
    device raises."""
    global launches, deposits
    supports(g)
    dev = fcoef.device
    if dev.type == "cpu":
        return fused_push_multi_ref(species, fcoef, acc, g, qms, max_streak,
                                    walls)
    if dev.type != "cuda":
        raise ValueError(f"fused_push_multi: unsupported device {dev}")
    check_walls(g, walls, dev)
    _check(fcoef, "fcoef", torch.float32, (g.nv, 18), dev)
    _check(acc, "acc", torch.float32, (g.nv, 12), dev)
    for k, sp in enumerate(species):
        n = sp.capacity
        for name in ("dx", "dy", "dz", "ux", "uy", "uz", "w"):
            _check(getattr(sp, name), f"species[{k}].{name}", torch.float32,
                   (n,), dev)
        _check(sp.i, f"species[{k}].i", torch.int32, (n,), dev)
        _check(sp.live, f"species[{k}].live", torch.bool, (n,), dev)
    if len(species) != len(qms):
        raise ValueError("one (charge, mass) pair per species")

    lib = _kernel_lib()
    unfinished = torch.zeros((1,), dtype=torch.int32, device=dev)
    deposits = deposit_counter(deposits, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    pends, disps = wall_outputs(species, walls)
    for grp in species_groups(species):
        sps = [species[k] for k in grp]
        pick = lambda ts: None if ts is None else [ts[k] for k in grp]
        ptrs, n, qdt_2mc, qsp, qr8v = c_species_table(
            sps, [qms[k] for k in grp], g, pends=pick(pends),
            disps=pick(disps))
        blk0, grid = launch_plan([-(-sp.capacity // LANES) for sp in sps])
        rc = lib.fused_push2d(
            len(sps), ptrs, n, c_array(ctypes.c_int, blk0), qdt_2mc, qsp,
            qr8v, grid, fcoef.data_ptr(), acc.data_ptr(),
            unfinished.data_ptr(), deposits.data_ptr(), *push_constants(g),
            max_streak, *wall_constants(g, walls), stream)
        if rc != 0:
            msg = lib.fused_push2d_error_string(rc).decode()
            raise RuntimeError(f"fused_push2d launch failed: {msg} ({rc})")
        launches += 1
    return recount(species, walls), acc, unfinished[0]
