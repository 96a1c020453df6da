"""In-grid compaction on the card (counterpart of
``scripts/residency_grid_bench.py``): NB = 64 blocks of (16, 4096) float32,
each compacted by its keep mask (variant ``compact``) or copied (variant
``copy``: compact_blocks without a mask, its own kernel).

    python -m vpic_tpu_torch.scripts.residency_grid_bench [--cpu]

``scripts/residency_grid_bench2.py`` computes the same function: its
variants ``highest`` and ``split4`` (four bf16 passes) are precision
workarounds for the TPU's one-hot matrix-unit dots, and ``copy`` is the
copy.  On Hopper that function is csrc/compact_block.cu through
ops/compact.compact_blocks: compact_kernel, and block_copy_kernel for the
copy.

Inputs, drawn from np.random.default_rng(0) as the JAX scripts draw them:
pk (16, NB 4096) normal and a ~12 % removal mask.  Every block must equal
an exact numpy compaction (the JAX scripts check block 0), and the kernel
its plain version, bit for bit.  Timed with CUDA events (best of 3 windows
of 50 calls): ms per call and us per block for kernel, plain version and
library call -- pk.clone() for the copy, pk[:, keep] over the whole array
for the compaction (every block's kept columns in order, without the
per-block zeros) -- and from torch.profiler the device time per call of
the kernel (``device_ms``) and of every kernel the library call launches
(``library_device_ms``).  Back to back, the 16.8 MB input stays in the
50 MB L2; ``cold_device_ms`` and ``library_cold_device_ms`` are the same
device times with a 64 MB write before every call (less the write's own
time).  --cpu runs the plain version against numpy only.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import compact as C
from . import card, cuda_ms, device, device_ms, kernel_device_ms
from .residency_proto import P, REMOVE, check_compaction

NB = 64
ROWS = 16
REPS = 50
FLUSH_BYTES = 64 << 20      # a write larger than the H100's 50 MB L2


def inputs(nb: int = NB):
    """(pk (16, nb P), keep (nb P,) 0/1 float32), as the JAX scripts."""
    rng = np.random.default_rng(0)
    pk = rng.normal(size=(ROWS, nb * P)).astype(np.float32)
    keep = (rng.random((1, nb * P)) > REMOVE).astype(np.float32)[0]
    return pk, keep


def cold_device_ms(fn, flush: torch.Tensor, n: int) -> float:
    """Device ms per fn() call with ``flush`` zeroed before each call:
    the pair's device time less the zeroing's own."""
    return (device_ms(lambda: (flush.zero_(), fn()), n)
            - device_ms(flush.zero_, n))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="residency_grid_bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="plain version against numpy only")
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    pk, keep = inputs()
    masks = {"copy": None, "compact": keep}
    kernels = {"copy": "block_copy_kernel", "compact": "compact_kernel"}
    res = {"device": str(dev), "blocks": NB}
    for variant, mask in masks.items():
        res[variant] = check_compaction(pk, mask, P, dev)
    if dev.type == "cuda":
        pk_t = torch.as_tensor(pk, device=dev)
        keep_b = torch.as_tensor(keep, device=dev) != 0
        library = {"copy": lambda: pk_t.clone(),
                   "compact": lambda: pk_t[:, keep_b]}
        flush = torch.empty(FLUSH_BYTES // 4, device=dev)
        for variant, mask in masks.items():
            keep_t = None if mask is None else torch.as_tensor(mask,
                                                               device=dev)
            r = res[variant]
            r.update(
                ms=cuda_ms(lambda: C.compact_blocks(pk_t, keep_t, P), REPS),
                plain_ms=cuda_ms(
                    lambda: C.compact_blocks_ref(pk_t, keep_t, P), REPS),
                library_ms=cuda_ms(library[variant], REPS),
                library_device_ms=device_ms(library[variant], REPS),
                cold_device_ms=cold_device_ms(
                    lambda: C.compact_blocks(pk_t, keep_t, P), flush, REPS),
                library_cold_device_ms=cold_device_ms(library[variant],
                                                      flush, REPS),
                device_ms=kernel_device_ms(
                    lambda: C.compact_blocks(pk_t, keep_t, P),
                    kernels[variant], REPS))
            r["us_per_block"] = r["ms"] * 1e3 / NB
        res["card"] = card()
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
