"""The residency prototypes on the card: stable block compaction and mailbox
copies (counterpart of ``scripts/residency_proto.py``).

    python -m vpic_tpu_torch.scripts.residency_proto [--cpu]

Inputs, drawn from np.random.default_rng(0) in the JAX script's order: a
(9, 4096) float32 block with ~12 % of its lanes removed, then 96 mailbox
blocks of (16, 128) copied to a permutation of the 128-aligned offsets.  The
compaction (ops/compact.compact_blocks, csrc/compact_block.cu) and the
mailbox (ops/compact.mailbox, csrc/mailbox.cu), into a new zeroed output and
(``mailbox_out``) into a NaN-filled ``out=``, must equal an exact numpy
compaction and copy, and their plain versions, bit for bit.  Timed with CUDA
events (best of 3 windows): ms per compaction of the block and per mailbox
of the 96 blocks, for kernel, plain version and library call -- pk[:, keep]
for the block; for the mailbox, each into an output made beforehand
(``out=``), the library call index_copy_ of every block's columns, its
column index made beforehand too.  From torch.profiler: the kernels' device
time per call (``device_ms``) and that of every kernel the library call
launches (``library_device_ms``); at these sizes the CUDA-event times are
set by the host.  --cpu runs the plain versions against numpy only.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import compact as C
from . import (card, cuda_ms, device, device_ms, kernel_device_ms,
               same_bits)

P = 4096            # lanes per block
REMOVE = 0.12       # share of lanes removed
NBLOCKS = 96        # mailbox blocks
COMPACT_REPS = 200
MAILBOX_REPS = 100


def inputs():
    """(pk (9, P), keep (P,) 0/1 float32, mailbox pk (16, 128 NBLOCKS),
    offsets (NBLOCKS,) int32), as the JAX script draws them."""
    rng = np.random.default_rng(0)
    pk = rng.normal(size=(9, P)).astype(np.float32)
    keep = (rng.random(P) > REMOVE).astype(np.float32)
    width = C.MAILBOX_WIDTH
    big = rng.normal(size=(16, width * NBLOCKS)).astype(np.float32)
    offs = (rng.permutation(NBLOCKS) * width).astype(np.int32)
    return pk, keep, big, offs


def compact_np(pk: np.ndarray, keep: np.ndarray, block: int):
    """Exact stable compaction of every block in numpy: (out, counts)."""
    out = np.zeros_like(pk)
    counts = []
    for b0 in range(0, pk.shape[1], block):
        idx = np.nonzero(keep[b0:b0 + block] != 0)[0]
        out[:, b0:b0 + len(idx)] = pk[:, b0 + idx]
        counts.append(len(idx))
    return out, np.asarray(counts, np.int32)


def mailbox_np(pk: np.ndarray, offs: np.ndarray, n_out: int,
               fill: float = 0.0) -> np.ndarray:
    """Every block's columns copied to its offset in an output filled with
    ``fill``, in numpy (offsets that fit and are 128-aligned, as the JAX
    script's)."""
    width = C.MAILBOX_WIDTH
    out = np.full((pk.shape[0], n_out), fill, np.float32)
    for b, o in enumerate(offs):
        out[:, o:o + width] = pk[:, b * width:(b + 1) * width]
    return out


def check_compaction(pk: np.ndarray, keep, block: int,
                     dev: torch.device) -> dict:
    """compact_blocks on ``dev`` against numpy and, on the card, against
    its plain version, bit for bit with equal counts; raises otherwise.
    ``keep`` is a numpy 0/1 mask, a torch mask (bool or float32) or None
    (the copy)."""
    keep_t = None if keep is None else torch.as_tensor(keep).to(dev)
    keep_np = (np.ones(pk.shape[1]) if keep is None
               else keep_t.cpu().numpy())
    pk_t = torch.as_tensor(pk, device=dev)
    out, cnt = C.compact_blocks(pk_t, keep_t, block)
    ref, ref_cnt = compact_np(pk, keep_np, block)
    if not (same_bits(out.cpu(), torch.from_numpy(ref))
            and np.array_equal(cnt.cpu().numpy(), ref_cnt)):
        raise AssertionError(f"compaction {pk.shape} differs from numpy")
    err = 0.0
    if dev.type == "cuda":
        plain, plain_cnt = C.compact_blocks_ref(pk_t, keep_t, block)
        if not (same_bits(out, plain) and torch.equal(cnt, plain_cnt)):
            raise AssertionError(f"compaction {pk.shape}: kernel differs "
                                 "from its plain version")
        err = float((out - plain).abs().max())
    return {"shape": list(pk.shape), "block": block,
            "kept": int(ref_cnt.sum()), "bit_exact": True,
            "max_abs_err": err}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="residency_proto", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="plain versions against numpy only")
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    pk, keep, big, offs = inputs()
    width = C.MAILBOX_WIDTH
    n_out = width * NBLOCKS

    comp = check_compaction(pk, keep, P, dev)
    big_t = torch.as_tensor(big, device=dev)
    offs_t = torch.as_tensor(offs, device=dev)
    res = {"device": str(dev), "compaction": comp}
    # into a new zeroed output, and into a NaN-filled out=
    for name, fill in (("mailbox", None), ("mailbox_out", float("nan"))):
        given = lambda: (None if fill is None
                         else torch.full((16, n_out), fill, device=dev))
        got = C.mailbox(big_t, offs_t, n_out, given())
        want = mailbox_np(big, offs, n_out, 0.0 if fill is None else fill)
        if not same_bits(got.cpu(), torch.from_numpy(want)):
            raise AssertionError(f"{name} differs from numpy")
        res[name] = {"blocks": NBLOCKS, "shape": [16, width],
                     "bit_exact": True, "max_abs_err": 0.0}
        if dev.type == "cuda":
            plain = C.mailbox_ref(big_t, offs_t, n_out, given())
            if not same_bits(got, plain):
                raise AssertionError(f"{name}: kernel differs from its "
                                     "plain version")
            res[name]["max_abs_err"] = float((got - plain).abs().max())

    if dev.type == "cuda":
        mail = res["mailbox"]
        pk_t = torch.as_tensor(pk, device=dev)
        keep_t = torch.as_tensor(keep, device=dev)
        keep_b = keep_t != 0
        comp.update(
            ms=cuda_ms(lambda: C.compact_blocks(pk_t, keep_t, P),
                       COMPACT_REPS),
            plain_ms=cuda_ms(lambda: C.compact_blocks_ref(pk_t, keep_t, P),
                             COMPACT_REPS),
            library_ms=cuda_ms(lambda: pk_t[:, keep_b], COMPACT_REPS),
            library_device_ms=device_ms(lambda: pk_t[:, keep_b],
                                        COMPACT_REPS),
            device_ms=kernel_device_ms(
                lambda: C.compact_blocks(pk_t, keep_t, P), "compact_kernel",
                COMPACT_REPS))
        cols = (offs_t.long()[:, None]
                + torch.arange(width, device=dev)).reshape(-1)
        k_out, p_out, lib_out = (torch.zeros((16, n_out), device=dev)
                                 for _ in range(3))
        mail.update(
            ms=cuda_ms(lambda: C.mailbox(big_t, offs_t, n_out, k_out),
                       MAILBOX_REPS),
            plain_ms=cuda_ms(lambda: C.mailbox_ref(big_t, offs_t, n_out,
                                                   p_out), MAILBOX_REPS),
            library_ms=cuda_ms(lambda: lib_out.index_copy_(1, cols, big_t),
                               MAILBOX_REPS),
            library_device_ms=device_ms(
                lambda: lib_out.index_copy_(1, cols, big_t), MAILBOX_REPS),
            device_ms=kernel_device_ms(
                lambda: C.mailbox(big_t, offs_t, n_out, k_out),
                "mailbox_kernel", MAILBOX_REPS))
        res["card"] = card()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
