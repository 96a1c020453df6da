"""The main path's particle push: bucket sort plus the hand-written CUDA push
kernel (counterpart of ``vpic_tpu/ops/pallas_push.py``).

``fused_push_multi`` pushes every species and deposits their currents into
one (nv, 12) accumulator.  On CUDA tensors it launches
``csrc/fused_push2d.cu`` once per species (on the current stream; the
particle tensors are updated in place); on CPU tensors it runs the plain
version ``fused_push_multi_ref`` (``ops/push.advance_p`` per species).  It
never falls back from one to the other.

The kernel works in canonical voxels and wraps periodic faces itself, so
none of the TPU kernel's voxel windows, ghost residents or outlier replay
exist here.  Faces it does not implement (absorbing, custom, remote) make
``supports`` raise: such decks wait for the boundary layer.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from ..grid import P_PERIODIC, Grid
from ..state import SpeciesState
from . import _build
from .push import UNFINISHED, advance_p, check_particle_bcs, gather_sp_rows

BUCKET = 128
KERNEL = "fused_push2d"

# Kernel launches made by fused_push_multi since the count was last reset.
launches = 0


def supports(g: Grid) -> bool:
    """True when the push kernel can run this grid; raises otherwise
    (2-D, one device, periodic or reflecting particle faces only)."""
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


def fused_push_multi_ref(species: Sequence[SpeciesState], fcoef, acc,
                         g: Grid, qms, max_streak: int = 4):
    """Plain PyTorch version of fused_push_multi: advance_p per species into
    the shared accumulator.  Returns (species, acc, unfinished) like the
    kernel path, with new species tensors."""
    supports(g)
    out = []
    unfinished = torch.zeros((), dtype=torch.int32, device=acc.device)
    for sp, (q, m) in zip(species, qms):
        res = advance_p(sp, fcoef, g, q, m, acc, max_streak=max_streak)
        out.append(res.species)
        unfinished = unfinished + (res.pend_face == UNFINISHED).sum(
            dtype=torch.int32)
    return out, acc, unfinished


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


_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int]
             + [ctypes.c_float] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.fused_push2d
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.fused_push2d_error_string.argtypes = [ctypes.c_int]
        lib.fused_push2d_error_string.restype = ctypes.c_char_p
    return lib


def fused_push_multi(species: Sequence[SpeciesState], fcoef: torch.Tensor,
                     acc: torch.Tensor, g: Grid,
                     qms: Sequence[Tuple[float, float]],
                     max_streak: int = 4
                     ) -> Tuple[List[SpeciesState], torch.Tensor,
                                torch.Tensor]:
    """Push every species one step and deposit their currents.

    ``fcoef`` is the (nv, 18) load_interpolator table, ``acc`` the (nv, 12)
    float32 accumulator (added to in place), ``qms`` (charge, mass) per
    species.  Returns (species, acc, unfinished), where ``unfinished`` is a
    0-d int32 device tensor counting lanes still walking after
    ``max_streak`` rounds.

    CUDA tensors: one kernel launch per species; the species tensors are
    updated IN PLACE and the same objects are returned.  CPU tensors: the
    plain version, which returns new tensors.  Any other device raises."""
    global launches
    supports(g)
    dev = fcoef.device
    if dev.type == "cpu":
        return fused_push_multi_ref(species, fcoef, acc, g, qms, max_streak)
    if dev.type != "cuda":
        raise ValueError(f"fused_push_multi: unsupported device {dev}")
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    periodic = [int(g.axis_bc(ax, -1, particles=True) == P_PERIODIC)
                for ax in range(3)]
    cdt = (g.cvac * g.dt * g.rdx, g.cvac * g.dt * g.rdy,
           g.cvac * g.dt * g.rdz)
    for sp, (q, m) in zip(species, qms):
        if sp.capacity == 0:
            continue
        qdt_2mc = (q * g.dt) / (2.0 * m * g.cvac)
        rc = lib.fused_push2d(
            sp.dx.data_ptr(), sp.dy.data_ptr(), sp.dz.data_ptr(),
            sp.i.data_ptr(), sp.ux.data_ptr(), sp.uy.data_ptr(),
            sp.uz.data_ptr(), sp.w.data_ptr(), sp.live.data_ptr(),
            fcoef.data_ptr(), acc.data_ptr(), unfinished.data_ptr(),
            sp.capacity, qdt_2mc, q, *cdt, g.nx, g.ny, g.nz, *periodic,
            max_streak, stream)
        if rc != 0:
            msg = lib.fused_push2d_error_string(rc).decode()
            raise RuntimeError(f"fused_push2d launch failed: {msg} ({rc})")
        launches += 1
    return list(species), acc, unfinished[0]
