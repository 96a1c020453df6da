"""The field trio advance_b(1/2), advance_e, advance_b(1/2) as one kernel
(counterpart of ``scripts/field_fuse_proto.py``), the step's field advance
wherever it covers the deck.

:func:`make_beb` returns ``beb(f)``, which runs the trio on a FieldState IN
PLACE (E, cB and TCA with their ghost planes; jf is read) and returns it, as
the port's field ops do.  On CUDA tensors it makes one launch of
``csrc/field_beb.cu``; on CPU tensors it runs the plain version
:func:`beb_ref` (``ops/fields.advance_b``, ``advance_e``, ``advance_b``).
It never falls back from one to the other.

The kernel is one cooperative launch over the whole card, at every grid
size.

The kernel covers one device with periodic, pec, symmetric and pmc field
faces and 0-d (single material) coefficients; :func:`supports_beb` says
whether a deck is one of those, and :func:`make_beb` raises on the rest
(absorbing faces, material meshes, decomposed grids).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Optional

import torch

from ..grid import (ABSORB_FIELDS, ANTI_SYMMETRIC, PERIODIC, PMC, REMOTE,
                    SYMMETRIC, Grid)
from ..state import FieldState, MaterialCoeffs
from . import _build
from . import fields as F
from .fused_push import _check

KERNEL = "field_beb"
THREADS = 256               # the kernel's CUDA block
FIELDS = ("ex", "ey", "ez", "cbx", "cby", "cbz", "tcax", "tcay", "tcaz",
          "jfx", "jfy", "jfz")
OUTPUTS = FIELDS[:9]

# Kernel launches made by beb since the count was last reset.
launches = 0

# ghost_tang_b's rule per face bc: 0 wrap, 1 mirror plane, -1 its negation
_GHOST = {PERIODIC: 0, ANTI_SYMMETRIC: 1, SYMMETRIC: -1, PMC: -1}


def beb_ref(f: FieldState, g: Grid, m: MaterialCoeffs,
            damp: float) -> FieldState:
    """Plain PyTorch version: the three field ops, in place."""
    F.advance_b(f, g, 0.5)
    F.advance_e(f, g, m, damp)
    F.advance_b(f, g, 0.5)
    return f


def refusal(g: Grid, m: MaterialCoeffs) -> Optional[str]:
    """Why the kernel does not cover this grid and material, or None."""
    if g.sharded or g.face_partners is not None:
        return "decomposed grids and join tables need the remote faces"
    if g.nv >= 2**31:
        return "the kernel indexes voxels in 32 bits"
    for face, bc in enumerate(g.field_bc):
        if bc == ABSORB_FIELDS:
            return f"face {face} is absorbing (Higdon ghosts)"
        if bc == REMOTE:
            return f"face {face} is remote"
        if bc not in _GHOST:
            return f"face {face} has an unknown field bc {bc}"
    for fld in dataclasses.fields(m):
        if getattr(m, fld.name).dim() != 0:
            return f"material coefficient {fld.name} is a mesh array"
    return None


def supports_beb(g: Grid, m: MaterialCoeffs) -> bool:
    """True when the fused kernel covers this grid and material: one device,
    periodic / pec / symmetric / pmc field faces, 0-d coefficients."""
    return refusal(g, m) is None


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.field_beb_grid.argtypes is None:
        head = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p] * 2
        lib.field_beb_grid.argtypes = head + [ctypes.c_int, ctypes.c_void_p]
        lib.field_beb_grid.restype = ctypes.c_int
        lib.field_beb_error_string.argtypes = [ctypes.c_int]
        lib.field_beb_error_string.restype = ctypes.c_char_p
    return lib


def kernel_args(g: Grid, m: MaterialCoeffs, damp: float):
    """The kernel's coefficient and face arguments as ctypes arrays: coef
    (17 floats: pb[3], pe[3], damp, dt/eps0, decay[3], drive[3], rmu[3])
    and faces (12 ints: the ghost rule and the pec flag of each face), as
    csrc/field_beb.cu's entry takes them."""
    d = (g.rdx, g.rdy, g.rdz)
    flat = (g.gnx == 1, g.gny == 1, g.gnz == 1)
    # the same Python expressions as ops/fields, so the same float32 values
    pb = [0.0 if flat[a] else 0.5 * g.cvac * g.dt * d[a] for a in range(3)]
    pe = [0.0 if flat[a] else (1 + damp) * g.cvac * g.dt * d[a]
          for a in range(3)]
    host = lambda *names: [float(getattr(m, n)) for n in names]
    coef = (pb + pe + [float(damp), g.dt / g.eps0]
            + host("decayx", "decayy", "decayz")
            + host("drivex", "drivey", "drivez")
            + host("rmux", "rmuy", "rmuz"))
    faces = ([_GHOST[bc] for bc in g.field_bc]
             + [int(bc == ANTI_SYMMETRIC) for bc in g.field_bc])
    return ((ctypes.c_float * len(coef))(*coef),
            (ctypes.c_int * len(faces))(*faces))


def make_beb(g: Grid, m: MaterialCoeffs,
             damp: float) -> Callable[[FieldState], FieldState]:
    """The trio for this grid, material and damping as ``beb(f)``.  The 0-d
    coefficients are read to host floats here, once, so no call syncs with
    the device.  Raises NotImplementedError where supports_beb is False."""
    why = refusal(g, m)
    if why:
        raise NotImplementedError(f"field_beb: {why}")
    cells = (g.nx, g.ny, g.nz)
    c_coef, c_faces = kernel_args(g, m, damp)

    def beb(f: FieldState) -> FieldState:
        global launches
        dev = f.ex.device
        if dev.type == "cpu":
            return beb_ref(f, g, m, damp)
        if dev.type != "cuda":
            raise ValueError(f"field_beb: unsupported device {dev}")
        arrays = [getattr(f, n) for n in FIELDS]
        for n, a in zip(FIELDS, arrays):
            _check(a, n, torch.float32, g.shape, dev)
        lib = _lib()
        ptrs = [a.data_ptr() for a in arrays]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.field_beb_grid(*ptrs, *cells, c_coef, c_faces, THREADS,
                                stream)
        if rc != 0:
            msg = lib.field_beb_error_string(rc).decode()
            raise RuntimeError(f"field_beb launch failed: {msg} ({rc})")
        launches += 1
        return f

    return beb
