"""The cleaners' charge deposit: every species' live lanes into ``rhof``'s
nodes (accumulate_rho_p, rho_p.cc:22-112).

``accumulate_rho_multi`` deposits every species.  On CUDA tensors it
launches ``csrc/rho_p.cu`` once for every species (fused_push.MAX_SPECIES
to a launch, on the current stream): with home maps (the 3-D path's block ->
home-brick maps) each CUDA block deposits a run of one brick's layout
blocks into a shared-memory tile of the brick's nodes, and the lanes
outside their block's brick take the global path; without them every lane
takes the global path, whose atomics are aggregated within the warp by
voxel.  ``deposits`` counts on the card the lanes that took the global
path and every live lane deposited.  On CPU tensors it runs the plain
version, ``ops/push.accumulate_rho_p`` per species (the JAX package's
cell-moment form, bit for bit what ran before the kernel).  It never falls
back from one to the other.

The kernel replaces no TPU kernel (``vpic_tpu`` runs the deposit as plain
``jnp``).  Its bound is bytes, ~21 a live lane; the source says what the
tiles and the warp aggregation do about the contended adds.  It reads
nothing on the host and allocates nothing but the counter at its first
launch on a device, so a step captured in a CUDA graph holds it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..grid import Grid
from ..state import SpeciesState
from . import _build
from .fused_push import (_check, c_array, deposit_counter, resident_blocks,
                         species_groups)
from .fused_push3d import run_length
from .push import accumulate_rho_p

KERNEL = "rho_p"
LANES = 1024                # lanes of a layout block
B3 = 8                      # brick side (cells) of the home maps

# Kernel launches made by accumulate_rho_multi since the count was last
# reset.
launches = 0
# Lanes of those launches, on the card: [taken the global path, every live
# lane].  None until the first launch; set it to None to reset the count.
deposits = None

_ARGTYPES = ([ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
             + [ctypes.POINTER(ctypes.c_int)] * 3
             + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int] * 3
             + [ctypes.c_void_p] + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 2)


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.rho_p.argtypes is None:
        lib.rho_p.argtypes = _ARGTYPES
        lib.rho_p.restype = ctypes.c_int
        lib.rho_p_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.rho_p_blocks_per_sm.restype = ctypes.c_int
        lib.rho_p_error_string.argtypes = [ctypes.c_int]
        lib.rho_p_error_string.restype = ctypes.c_char_p
    return lib


def interleave_plan(nblocks: Sequence[int], run: int):
    """(head, blk0, grid) of one launch: species k's ``nblocks[k]`` layout
    blocks in runs of ``run`` take ceil(nblocks[k] / run) CUDA blocks, of
    ``grid`` in all.  The first ``head`` of every species (the fewest any
    species takes) are dealt round-robin: CUDA block j * nsp + k is species
    k's j-th, so the species' adds, of both signs, reach rhof together.
    The rest follow species after species, species k's from blk0[k]."""
    if run < 1:
        raise ValueError(f"run={run} must be at least 1")
    counts = [-(-nb // run) for nb in nblocks]
    head = min(counts)
    blk0, grid = [], head * len(counts)
    for c in counts:
        blk0.append(grid)
        grid += c - head
    return head, blk0, grid


def check(rhof_flat: torch.Tensor, species: Sequence[SpeciesState], qs,
          g: Grid, homes: Optional[Sequence[torch.Tensor]] = None):
    """Raise unless the arguments are what accumulate_rho_multi takes: a
    flat (nv,) float32 ``rhof_flat`` on the CPU or the card; per species
    float32 dx, dy, dz, w, int32 voxels and bool live marks of one length
    on rhof's device, each contiguous; one charge per species; and
    ``homes``, if given, one 1-D int32 map per species of at most
    ceil(capacity / 1024) layout blocks on a grid of 8^3 bricks."""
    dev = rhof_flat.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"accumulate_rho_multi: unsupported device {dev}")
    _check(rhof_flat, "rhof", torch.float32, (g.nv,), dev)
    if g.nv >= (1 << 31):
        raise NotImplementedError(f"nv {g.nv}: the kernel indexes nodes "
                                  "with int32")
    if len(qs) != len(species):
        raise ValueError("one charge per species")
    for k, sp in enumerate(species):
        n = (sp.capacity,)
        for name in ("dx", "dy", "dz", "w"):
            _check(getattr(sp, name), f"species[{k}].{name}", torch.float32,
                   n, dev)
        _check(sp.i, f"species[{k}].i", torch.int32, n, dev)
        _check(sp.live, f"species[{k}].live", torch.bool, n, dev)
    if homes is None:
        return
    if len(homes) != len(species):
        raise ValueError("one home map per species")
    if g.nz <= 1 or g.nx % B3 or g.ny % B3 or g.nz % B3:
        raise ValueError(f"grid {g.nx}x{g.ny}x{g.nz}: home maps need a 3-D "
                         "grid of 8^3 bricks")
    for k, (sp, hm) in enumerate(zip(species, homes)):
        most = -(-sp.capacity // LANES)
        if hm.dim() != 1 or hm.shape[0] > most:
            raise ValueError(f"homes[{k}] has shape {tuple(hm.shape)}, "
                             f"expected at most ({most},)")
        _check(hm, f"homes[{k}]", torch.int32, tuple(hm.shape), dev)


def accumulate_rho_multi(rhof_flat: torch.Tensor,
                         species: Sequence[SpeciesState], qs, g: Grid,
                         homes: Optional[Sequence[torch.Tensor]] = None):
    """Add the uncorrected trilinear charge of every species' live lanes
    (charge ``qs[k]`` per unit weight) to flat ``rhof_flat`` in place, and
    return it.

    ``homes``: the per-species block -> home-brick maps of the 3-D path
    (``diag["_chart_home{k}"]``), which let the kernel deposit through
    brick tiles; blocks past a map, and lanes outside their block's brick,
    take the global path, so any layout gives the same sum.  The plain
    version ignores them.

    CUDA tensors: one kernel launch for every fused_push.MAX_SPECIES
    species; the module's ``deposits`` counts the launch's lanes.  The sums
    are taken in another order than the plain version's, with atomics in an
    order that changes from run to run.  CPU tensors: ``accumulate_rho_p``
    per species."""
    global launches, deposits
    check(rhof_flat, species, qs, g, homes)
    dev = rhof_flat.device
    if dev.type == "cpu":
        for sp, q in zip(species, qs):
            accumulate_rho_p(rhof_flat, sp, g, q)
        return rhof_flat
    groups = species_groups(species)
    if not groups:
        return rhof_flat
    lib = _kernel_lib()
    tile = homes is not None
    deposits = deposit_counter(deposits, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    slots = resident_blocks(lib.rho_p_blocks_per_sm, int(tile), dev)
    for grp in groups:
        nblocks = [-(-species[k].capacity // LANES) for k in grp]
        run = run_length(sum(nblocks), slots)
        head, blk0, grid = interleave_plan(nblocks, run)
        ptrs = []
        for k in grp:
            sp = species[k]
            ptrs += [t.data_ptr() for t in (sp.dx, sp.dy, sp.dz, sp.i, sp.w,
                                            sp.live)]
            ptrs.append(homes[k].data_ptr() if tile else None)
        rc = lib.rho_p(
            len(grp), c_array(ctypes.c_void_p, ptrs),
            c_array(ctypes.c_int, [species[k].capacity for k in grp]),
            c_array(ctypes.c_int,
                    [homes[k].shape[0] if tile else 0 for k in grp]),
            c_array(ctypes.c_int, blk0),
            c_array(ctypes.c_float, [qs[k] * g.r8V for k in grp]),
            grid, head, run, rhof_flat.data_ptr(), g.nx, g.ny, g.nz,
            int(tile),
            deposits.data_ptr(), stream)
        if rc != 0:
            msg = lib.rho_p_error_string(rc).decode()
            raise RuntimeError(f"rho_p launch failed: {msg} ({rc})")
        launches += 1
    return rhof_flat
