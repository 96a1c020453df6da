"""The walk of lanes a boundary handler re-emits (the reference's move_p
re-injection, boundary_p.cc:440-494; ``_continue_walk`` in
``vpic_tpu/boundary_ops.py``).

``move_p`` walks the remaining displacement of a species' lanes that are
live and marked ``active``, against this rank's domain faces (and a
per-voxel-face table where the caller passes one: the migration rounds
walk received lanes on with it, vpic_tpu/boundary.py:176-190; a handler's
continuation passes none, as the JAX package's), and writes the result
into the species in place.  On CUDA tensors it launches
``csrc/move_p.cu`` (one launch, one thread per slot, sharing the walk of
the push kernels, ``push_lane.cuh``); on CPU tensors it runs the plain
version ``move_p_ref`` (``ops/push.streak_walk`` over every lane).  It
never falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..grid import Grid
from . import _build
from .fused_push import _check
from .push import decode_voxel, particle_bcs, streak_walk

KERNEL = "move_p"

# Kernel launches made by move_p since the count was last reset.
launches = 0

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12
             + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def _kernel_lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.move_p.argtypes is None:
        lib.move_p.argtypes = _ARGTYPES
        lib.move_p.restype = ctypes.c_int
        lib.move_p_error_string.argtypes = [ctypes.c_int]
        lib.move_p_error_string.restype = ctypes.c_char_p
    return lib


def move_p_ref(sp, pend, disp, acc, rhob, g: Grid, qsp, active,
               max_streak: int = 4, vbc=None):
    """Plain version of move_p: streak_walk over every lane, the lanes that
    are not walking masked out."""
    (pos, disp, coords, u, alive, pend, acc, rhob) = streak_walk(
        g, qsp, sp.w, (sp.dx, sp.dy, sp.dz), tuple(disp),
        decode_voxel(sp.i, g), (sp.ux, sp.uy, sp.uz), active & sp.live,
        sp.live, pend, acc, rhob, max_streak, vbc=vbc)
    vox = coords[0] + g.NX * (coords[1] + g.NY * coords[2])
    for name, new in (("dx", pos[0]), ("dy", pos[1]), ("dz", pos[2]),
                      ("i", vox), ("ux", u[0]), ("uy", u[1]), ("uz", u[2])):
        getattr(sp, name).copy_(new)
    sp.w.copy_(torch.where(alive, sp.w, 0.0))
    sp.live.copy_(alive)
    return sp.replace(np=alive.sum(dtype=torch.int32)), pend, disp, acc, rhob


def move_p(sp, pend, disp, acc, rhob, g: Grid, qsp, active,
           max_streak: int = 4, vbc=None):
    """Walk the remaining displacement ``disp`` (a triple of (N,) tensors or
    a (3, N) tensor) of the lanes of ``sp`` that are live and ``active``,
    from their offsets, momentum and voxel: deposits into ``acc`` (nv, 12),
    an absorbed lane's charge (species charge ``qsp``) into ``rhob`` (nv,),
    both in place.  The species' lane tensors are updated in place (a lane
    that died: live False, w 0; every dead lane's w is 0 afterwards, as in
    the plain version).  ``vbc`` is the (nv, 6) int32 per-voxel-face code
    table or None.  Returns (species with np recounted, pend, disp, acc,
    rhob): pend is the (N,) int32 pend codes with UNFINISHED where the walk
    ran out of rounds, CUSTOM_BASE + face where it parked again and face
    where it reached a face another rank owns.

    CUDA tensors: one kernel launch; ``pend`` is updated in place when it is
    a contiguous int32 tensor, and the displacement comes back as the rows
    of a (3, N) tensor.  CPU tensors: the plain version, which returns new
    pend and displacement tensors.  Any other device raises."""
    global launches
    dev = sp.dx.device
    if dev.type == "cpu":
        return move_p_ref(sp, pend, disp, acc, rhob, g, qsp, active,
                          max_streak, vbc)
    if dev.type != "cuda":
        raise ValueError(f"move_p: unsupported device {dev}")
    n = sp.capacity
    for name in ("dx", "dy", "dz", "ux", "uy", "uz", "w"):
        _check(getattr(sp, name), f"sp.{name}", torch.float32, (n,), dev)
    _check(sp.i, "sp.i", torch.int32, (n,), dev)
    _check(sp.live, "sp.live", torch.bool, (n,), dev)
    _check(active, "active", torch.bool, (n,), dev)
    _check(acc, "acc", torch.float32, (g.nv, 12), dev)
    _check(rhob, "rhob", torch.float32, (g.nv,), dev)
    if vbc is not None:
        _check(vbc, "vbc", torch.int32, (g.nv, 6), dev)
    pend = pend.to(torch.int32).contiguous()
    disp = (torch.stack(tuple(disp)) if not isinstance(disp, torch.Tensor)
            else disp).to(torch.float32).contiguous()
    _check(pend, "pend", torch.int32, (n,), dev)
    _check(disp, "disp", torch.float32, (3, n), dev)
    lib = _kernel_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.move_p(
        n, sp.dx.data_ptr(), sp.dy.data_ptr(), sp.dz.data_ptr(),
        sp.i.data_ptr(), sp.ux.data_ptr(), sp.uy.data_ptr(),
        sp.uz.data_ptr(), sp.w.data_ptr(), sp.live.data_ptr(),
        active.data_ptr(), pend.data_ptr(), disp.data_ptr(), float(qsp),
        float(qsp * g.r8V), acc.data_ptr(), rhob.data_ptr(), g.nx, g.ny,
        g.nz, (ctypes.c_int * 6)(*particle_bcs(g)),
        None if vbc is None else vbc.data_ptr(), max_streak, stream)
    if rc != 0:
        msg = lib.move_p_error_string(rc).decode()
        raise RuntimeError(f"move_p launch failed: {msg} ({rc})")
    launches += 1
    sp.w.masked_fill_(~sp.live, 0.0)
    return (sp.replace(np=sp.live.sum(dtype=torch.int32)), pend,
            (disp[0], disp[1], disp[2]), acc, rhob)
