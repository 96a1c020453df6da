"""Block compaction and mailbox copies: the kernels of the residency
prototypes (counterparts of ``scripts/residency_proto.py``,
``scripts/residency_grid_bench.py`` and ``scripts/residency_grid_bench2.py``).

* :func:`compact_blocks` moves the kept lanes of every ``block``-lane block
  of an (R, nb * block) array to the front of the block, in lane order, with
  zeros after them, and returns the per-block kept counts.  On CUDA tensors
  it launches ``csrc/compact_block.cu``; on CPU tensors it runs the plain
  version :func:`compact_blocks_ref` (a cumsum, then a scatter).  The grid
  benches' copy variants are the same call with an all-true mask.
* :func:`mailbox` copies column block b of an (R, nb * 128) array to the
  output columns [offs[b], offs[b] + 128) of a zeroed (R, n_out) array.
  On CUDA tensors it launches ``csrc/mailbox.cu``; on CPU tensors it runs
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

import torch

from . import _build
from .fused_push import _check

KERNEL = "compact_block"
MAILBOX_KERNEL = "mailbox"
MAILBOX_WIDTH = 128       # the prototype's mailbox width (one lane tile)
THREADS = 128             # threads per mailbox block

# Kernel launches made by compact_blocks / mailbox since the counts were
# last reset.
launches = 0
mailbox_launches = 0


def _check_compact(pk, keep, block):
    if pk.dim() != 2:
        raise ValueError(f"pk must be (rows, lanes), got {tuple(pk.shape)}")
    if pk.dtype != torch.float32:
        raise TypeError(f"pk has dtype {pk.dtype}, expected torch.float32")
    P = pk.shape[1]
    if block <= 0 or P % block:
        raise ValueError(f"{P} lanes are not a whole number of {block}-lane "
                         "blocks")
    if keep.dtype not in (torch.bool, torch.float32):
        raise TypeError(f"keep has dtype {keep.dtype}, expected torch.bool "
                        "or torch.float32")
    if tuple(keep.shape) != (P,):
        raise ValueError(f"keep has shape {tuple(keep.shape)}, expected "
                         f"({P},)")
    return P // block


def compact_blocks_ref(pk: torch.Tensor, keep: torch.Tensor, block: int):
    """Plain PyTorch version of compact_blocks: per block, the exclusive
    cumsum of the mask gives each kept lane its slot and a scatter moves the
    columns there (dropped lanes go to a spare column).  Returns (out (R, P)
    float32, counts (nb,) int32)."""
    nb = _check_compact(pk, keep, block)
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
    KERNEL: ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 2
             + [ctypes.c_void_p]),
    MAILBOX_KERNEL: ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                     + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                     + [ctypes.c_void_p]),
}


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, name: str, rc: int):
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


def compact_blocks(pk: torch.Tensor, keep: torch.Tensor, block: int):
    """Stable compaction of every ``block``-lane block of ``pk`` (R, P)
    float32 by ``keep`` (P,) bool, or float32 with a lane kept where it is
    not 0: the kept lanes of each block move to its front in lane order and
    the rest of the block is zeros.  Returns (out (R, P) float32, counts
    (nb,) int32), new tensors.

    CUDA tensors: one launch of csrc/compact_block.cu.  CPU tensors: the
    plain version.  Any other device raises."""
    global launches
    dev = pk.device
    if dev.type == "cpu":
        return compact_blocks_ref(pk, keep, block)
    if dev.type != "cuda":
        raise ValueError(f"compact_blocks: unsupported device {dev}")
    nb = _check_compact(pk, keep, block)
    R, P = pk.shape
    _check(pk, "pk", torch.float32, (R, P), dev)
    _check(keep, "keep", keep.dtype, (P,), dev)
    out = torch.empty_like(pk)
    counts = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0 or R == 0:
        return out, counts.zero_()
    lib = _lib(KERNEL)
    rc = lib.compact_block(pk.data_ptr(), keep.data_ptr(),
                           int(keep.dtype == torch.float32), out.data_ptr(),
                           counts.data_ptr(), R, P, block, nb,
                           torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, KERNEL, rc)
    launches += 1
    return out, counts


def _check_mailbox(pk, offs, n_out):
    if pk.dim() != 2 or pk.dtype != torch.float32:
        raise TypeError("pk must be a (rows, columns) float32 tensor")
    if offs.dim() != 1 or offs.dtype != torch.int32:
        raise TypeError("offs must be a (nblocks,) int32 tensor")
    if n_out < 0 or n_out % 4 or pk.shape[1] % 4:
        raise ValueError(f"pk's {pk.shape[1]} and the output's {n_out} "
                         "columns must be multiples of 4 (16-byte rows)")
    nb = offs.shape[0]
    if nb * MAILBOX_WIDTH > pk.shape[1]:
        raise ValueError(f"{nb} blocks of {MAILBOX_WIDTH} columns need "
                         f"{nb * MAILBOX_WIDTH} columns, pk has "
                         f"{pk.shape[1]}")
    return nb


def mailbox_ref(pk: torch.Tensor, offs: torch.Tensor,
                n_out: int) -> torch.Tensor:
    """Plain PyTorch version of mailbox: one indexed assignment of every
    block's columns into a zeroed output with a spare block of columns,
    where the blocks that are skipped land."""
    nb = _check_mailbox(pk, offs, n_out)
    R = pk.shape[0]
    width = MAILBOX_WIDTH
    start = offs.to(torch.int64)
    fits = (start >= 0) & (start + width <= n_out) & (start % 4 == 0)
    start = torch.where(fits, start, n_out)
    cols = (start[:, None] + torch.arange(width, device=pk.device)).reshape(-1)
    out = torch.zeros((R, n_out + width), dtype=pk.dtype, device=pk.device)
    out[:, cols] = pk[:, :nb * width]
    return out[:, :n_out].contiguous()


def mailbox(pk: torch.Tensor, offs: torch.Tensor, n_out: int) -> torch.Tensor:
    """Copy columns [128 b, 128 (b + 1)) of ``pk`` (R, C) float32 to
    columns [offs[b], offs[b] + 128) of a zeroed (R, n_out) float32
    output, for every block b of ``offs`` (nb,) int32; C and n_out are
    multiples of 4.  A block whose offset is not a multiple of 4 (the
    prototype's are multiples of 128), or whose columns would not fit, is
    not copied; overlapping blocks give an undefined result.  Returns the
    new output.

    CUDA tensors: one launch of csrc/mailbox.cu.  CPU tensors: the plain
    version.  Any other device raises."""
    global mailbox_launches
    dev = pk.device
    if dev.type == "cpu":
        return mailbox_ref(pk, offs, n_out)
    if dev.type != "cuda":
        raise ValueError(f"mailbox: unsupported device {dev}")
    nb = _check_mailbox(pk, offs, n_out)
    R, C = pk.shape
    _check(pk, "pk", torch.float32, (R, C), dev)
    _check(offs, "offs", torch.int32, (nb,), dev)
    out = torch.zeros((R, n_out), dtype=torch.float32, device=dev)
    if nb == 0 or R == 0:
        return out
    lib = _lib(MAILBOX_KERNEL)
    rc = lib.mailbox(pk.data_ptr(), offs.data_ptr(), out.data_ptr(), R, C,
                     n_out, MAILBOX_WIDTH, nb, THREADS,
                     torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, MAILBOX_KERNEL, rc)
    mailbox_launches += 1
    return out
