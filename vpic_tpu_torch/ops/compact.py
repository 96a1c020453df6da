"""Block compaction, block copies and mailbox copies: the kernels of the
residency prototypes (counterparts of ``scripts/residency_proto.py``,
``scripts/residency_grid_bench.py`` and ``scripts/residency_grid_bench2.py``).

* :func:`compact_blocks` moves the kept lanes of every ``block``-lane block
  of an (R, nb * block) array to the front of the block, in lane order, with
  zeros after them, and returns the per-block kept counts.  With
  ``keep=None`` it is the grid benches' copy variant: the array copied, every
  count ``block``.  On CUDA tensors it launches one kernel of
  ``csrc/compact_block.cu`` (``compact_kernel``, or ``block_copy_kernel``
  without a mask); on CPU tensors it runs the plain version
  :func:`compact_blocks_ref` (a cumsum, then a scatter; a clone without a
  mask).
* :func:`mailbox` copies column block b of an (R, nb * 128) array to the
  output columns [offs[b], offs[b] + 128) of a zeroed (R, n_out) array, or
  of the caller's ``out``, whose other columns it leaves as they are.  On
  CUDA tensors it launches ``csrc/mailbox.cu``; on CPU tensors it runs
  :func:`mailbox_ref`.

Neither wrapper falls back from one version to the other.

The TPU compaction sources output segment s only from the input lanes
[S s, S s + 2S) (S = 512), so it is exact only while no kept lane moves by
more than about S; its one-hot dots also turn a -0.0 into +0.0.  Both are
TPU workarounds: the port computes the exact stable compaction and moves
every float unchanged.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .fused_push import _check

KERNEL = "compact_block"
COPY_KERNEL = "block_copy"        # keep=None, in csrc/compact_block.cu
MAILBOX_KERNEL = "mailbox"
MAILBOX_WIDTH = 128       # the prototype's mailbox width (one lane tile)
THREADS = 512             # threads per mailbox block: 16 rows x 32 float4

CHUNK = 1024              # lanes of a compaction CUDA block, one a thread
MAX_ROWS = 8              # rows a compaction thread moves at most
WAVES = 2                 # least CUDA blocks per SM a compaction grid has

# Kernel launches made by compact_blocks (with a mask, and without) and
# by mailbox since the counts were last reset.
launches = 0
copy_launches = 0
mailbox_launches = 0


class CompactPlan(NamedTuple):
    """Grid (nb, chunks, groups) of one compaction launch: CUDA block
    (b, c, g) serves lanes [CHUNK c, CHUNK (c + 1)) of lane block b and
    rows [rows_per_group g, rows_per_group (g + 1)), both cut at the end."""
    grid: tuple
    rows_per_group: int


def compact_plan(rows: int, block: int, nb: int, sms: int) -> CompactPlan:
    """The most rows per group (up to MAX_ROWS) that still give a grid of
    WAVES waves of ``sms`` SMs, or every row its own group where even that
    gives fewer.  Each CUDA block pays a fixed chain (mask load, scan,
    barriers) once, so fewer, fuller blocks are faster; the waves keep
    every SM busy."""
    if min(rows, block, nb, sms) < 1:
        raise ValueError(f"rows={rows}, block={block}, nb={nb}, sms={sms} "
                         "must all be at least 1")
    chunks = -(-block // CHUNK)
    need = -(-WAVES * sms // (nb * chunks))
    per = min(MAX_ROWS, max(1, rows // need))
    return CompactPlan((nb, chunks, -(-rows // per)), per)


def _check_compact(pk, keep, block):
    if pk.dim() != 2:
        raise ValueError(f"pk must be (rows, lanes), got {tuple(pk.shape)}")
    if pk.dtype != torch.float32:
        raise TypeError(f"pk has dtype {pk.dtype}, expected torch.float32")
    P = pk.shape[1]
    if block <= 0 or P % block:
        raise ValueError(f"{P} lanes are not a whole number of {block}-lane "
                         "blocks")
    if keep is not None:
        if keep.dtype not in (torch.bool, torch.float32):
            raise TypeError(f"keep has dtype {keep.dtype}, expected "
                            "torch.bool or torch.float32")
        if tuple(keep.shape) != (P,):
            raise ValueError(f"keep has shape {tuple(keep.shape)}, expected "
                             f"({P},)")
    return P // block


def compact_blocks_ref(pk: torch.Tensor, keep: Optional[torch.Tensor],
                       block: int):
    """Plain PyTorch version of compact_blocks: per block, the exclusive
    cumsum of the mask gives each kept lane its slot and a scatter moves the
    columns there (dropped lanes go to a spare column); without a mask,
    ``pk.clone()``.  Returns (out (R, P) float32, counts (nb,) int32)."""
    nb = _check_compact(pk, keep, block)
    if keep is None:
        return pk.clone(), torch.full((nb,), block, dtype=torch.int32,
                                      device=pk.device)
    R = pk.shape[0]
    kept = (keep != 0).view(nb, block)
    ki = kept.to(torch.int64)
    pos = torch.cumsum(ki, 1) - ki
    dst = torch.where(kept, pos, block)
    out = torch.zeros((R, nb, block + 1), dtype=pk.dtype, device=pk.device)
    out.scatter_(2, dst.expand(R, nb, block), pk.reshape(R, nb, block))
    return (out[:, :, :block].reshape(R, nb * block),
            ki.sum(1).to(torch.int32))


_ARGTYPES = {
    KERNEL: ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    COPY_KERNEL: ([ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p]),
    MAILBOX_KERNEL: ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                     + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                     + [ctypes.c_void_p]),
}
_SOURCE = {KERNEL: KERNEL, COPY_KERNEL: KERNEL,
           MAILBOX_KERNEL: MAILBOX_KERNEL}


def _fn(name: str):
    """(library, C function ``name``) with its argument types set."""
    lib = _build.load(_SOURCE[name])
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return lib, fn


def _raise_on(lib, name: str, rc: int):
    if rc != 0:
        err = getattr(lib, f"{_SOURCE[name]}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()} ({rc})")


def _stream(dev: torch.device) -> int:
    """The raw handle of the device's current stream (no Stream object:
    these wrappers' host time is most of a call's)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def compact_blocks(pk: torch.Tensor, keep: Optional[torch.Tensor],
                   block: int):
    """Stable compaction of every ``block``-lane block of ``pk`` (R, P)
    float32 by ``keep`` (P,) bool, or float32 with a lane kept where it is
    not 0: the kept lanes of each block move to its front in lane order and
    the rest of the block is zeros.  ``keep=None`` keeps every lane: a copy
    of ``pk`` that reads no mask.  Returns (out (R, P) float32, counts (nb,)
    int32), new tensors.

    CUDA tensors: one launch of csrc/compact_block.cu, nothing else on the
    device.  CPU tensors: the plain version.  Any other device raises."""
    global launches, copy_launches
    dev = pk.device
    if dev.type == "cpu":
        return compact_blocks_ref(pk, keep, block)
    if dev.type != "cuda":
        raise ValueError(f"compact_blocks: unsupported device {dev}")
    nb = _check_compact(pk, keep, block)
    R, P = pk.shape
    _check(pk, "pk", torch.float32, (R, P), dev)
    if keep is not None:
        _check(keep, "keep", keep.dtype, (P,), dev)
    out = torch.empty_like(pk)
    counts = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return out, counts
    stream = _stream(dev)
    if keep is None:
        lib, fn = _fn(COPY_KERNEL)
        rc = fn(pk.data_ptr(), out.data_ptr(), R * P, int(_aligned(pk, 16)),
                counts.data_ptr(), nb, block, stream)
        _raise_on(lib, COPY_KERNEL, rc)
        copy_launches += 1
        return out, counts
    is_float = keep.dtype == torch.float32
    vec = block % 4 == 0 and _aligned(keep, 16 if is_float else 4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = compact_plan(max(R, 1), block, nb, sms)
    lib, fn = _fn(KERNEL)
    rc = fn(pk.data_ptr(), keep.data_ptr(), int(is_float), int(vec),
            out.data_ptr(), counts.data_ptr(), R, P, block, nb,
            plan.rows_per_group, stream)
    _raise_on(lib, KERNEL, rc)
    launches += 1
    return out, counts


def _check_mailbox(pk, offs, n_out, out):
    """The number of blocks, after checking on the host, with no device op,
    everything the kernel needs of its arguments."""
    if pk.dim() != 2 or pk.dtype != torch.float32:
        raise TypeError("pk must be a (rows, columns) float32 tensor")
    if offs.dim() != 1 or offs.dtype != torch.int32:
        raise TypeError("offs must be a (nblocks,) int32 tensor")
    R, C = pk.shape
    if n_out < 0 or n_out % 4 or C % 4:
        raise ValueError(f"pk's {C} and the output's {n_out} columns must "
                         "be multiples of 4 (16-byte rows)")
    nb = offs.shape[0]
    if nb * MAILBOX_WIDTH > C:
        raise ValueError(f"{nb} blocks of {MAILBOX_WIDTH} columns need "
                         f"{nb * MAILBOX_WIDTH} columns, pk has {C}")
    dev = pk.get_device()
    if offs.get_device() != dev or not (pk.is_contiguous()
                                        and offs.is_contiguous()):
        raise ValueError("pk and offs must be contiguous and on one device")
    if out is not None:
        if out.dtype != torch.float32:
            raise TypeError(f"out has dtype {out.dtype}, expected "
                            "torch.float32")
        if out.shape != (R, n_out) or out.get_device() != dev or \
                not out.is_contiguous():
            raise ValueError(f"out must be a contiguous ({R}, {n_out}) "
                             f"tensor on {pk.device}")
    return nb


def mailbox_ref(pk: torch.Tensor, offs: torch.Tensor, n_out: int,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of mailbox: one indexed assignment of every
    block's columns into a copy of ``out`` (zeros without it) with a spare
    block of columns, where the blocks that are skipped land."""
    nb = _check_mailbox(pk, offs, n_out, out)
    R = pk.shape[0]
    width = MAILBOX_WIDTH
    start = offs.to(torch.int64)
    fits = (start >= 0) & (start + width <= n_out) & (start % 4 == 0)
    start = torch.where(fits, start, n_out)
    cols = (start[:, None] + torch.arange(width, device=pk.device)).reshape(-1)
    buf = torch.zeros((R, n_out + width), dtype=pk.dtype, device=pk.device)
    if out is not None:
        buf[:, :n_out] = out
    buf[:, cols] = pk[:, :nb * width]
    if out is None:
        return buf[:, :n_out].contiguous()
    return out.copy_(buf[:, :n_out])


def mailbox(pk: torch.Tensor, offs: torch.Tensor, n_out: int,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy columns [128 b, 128 (b + 1)) of ``pk`` (R, C) float32 to
    columns [offs[b], offs[b] + 128) of the output, for every block b of
    ``offs`` (nb,) int32; C and n_out are multiples of 4.  The output is
    ``out`` (R, n_out) float32 where given, written in place, its columns
    that no block covers left as they are; else a new zeroed (R, n_out)
    tensor.  A block whose offset is not a multiple of 4 (the prototype's
    are multiples of 128), or whose columns would not fit, is not copied;
    overlapping blocks give an undefined result.  Returns the output.

    CUDA tensors: one launch of csrc/mailbox.cu (after a zero fill when no
    ``out`` is given).  CPU tensors: the plain version.  Any other device
    raises."""
    global mailbox_launches
    if not pk.is_cuda:
        if pk.device.type == "cpu":
            return mailbox_ref(pk, offs, n_out, out)
        raise ValueError(f"mailbox: unsupported device {pk.device}")
    nb = _check_mailbox(pk, offs, n_out, out)
    R, C = pk.shape
    if out is None:
        out = torch.zeros((R, n_out), dtype=torch.float32, device=pk.device)
    if nb == 0 or R == 0:
        return out
    lib, fn = _fn(MAILBOX_KERNEL)
    rc = fn(pk.data_ptr(), offs.data_ptr(), out.data_ptr(), R, C, n_out, nb,
            THREADS, _stream(pk.device))
    _raise_on(lib, MAILBOX_KERNEL, rc)
    mailbox_launches += 1
    return out
