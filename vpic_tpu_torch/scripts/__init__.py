"""Entry points of the prototype kernels (counterparts of the JAX
package's ``scripts/`` micro-benchmarks):

    python -m vpic_tpu_torch.scripts.residency_proto [--cpu]
    python -m vpic_tpu_torch.scripts.residency_grid_bench [--cpu]
    python -m vpic_tpu_torch.scripts.field_fuse_proto [--cpu] [--nx N]
        [--ny N] [--nz N]

Each builds its JAX counterpart's inputs, holds the CUDA kernel against an
exact reference and against its plain PyTorch version, times kernel, plain
version and library call with CUDA events, and prints one JSON line;
``main(argv)`` returns it as a dict.  ``--cpu`` runs the plain versions
only; without it a machine with no CUDA card raises.
"""

from __future__ import annotations

import subprocess

import torch

WINDOWS = 3


def device(cpu: bool) -> torch.device:
    """The CPU when asked for, else the card; raises without one."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run the plain "
                           "versions on the CPU")
    return torch.device("cuda")


def cuda_ms(fn, n: int) -> float:
    """ms per call of fn(): the best of WINDOWS windows of n calls between
    CUDA events, after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / n)
    return best


def device_kernels(fn, n: int) -> dict:
    """{kernel name: (launches, device ms)} per fn() call, from
    torch.profiler's device events over n calls after one warm-up call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count / n, e.device_time_total / 1e3 / n)
            for e in prof.key_averages() if e.device_type.name == "CUDA"}


def kernel_device_ms(fn, kernel: str, n: int) -> float:
    """Device ms per fn() call in the kernels whose name holds ``kernel``."""
    return sum(ms for name, (_, ms) in device_kernels(fn, n).items()
               if kernel in name)


def device_ms(fn, n: int) -> float:
    """Device ms per fn() call in every kernel, copy and fill it launches."""
    return sum(ms for _, ms in device_kernels(fn, n).values())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when two float32 tensors hold the same bits."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def card() -> str:
    """The card a timing ran on, with its power limit, as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
