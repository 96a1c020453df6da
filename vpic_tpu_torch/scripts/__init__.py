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

import contextlib
import subprocess
import time

import torch

WINDOWS = 3
# torch.profiler on the H100 now and then recorded no device event in a
# window (seen in phase 9 and 10 windows and in the one-launch tests):
# such a window, or one without the kernel asked for, is profiled again,
# at most this many times in all.
PROFILE_TRIES = 3
# Kineto keeps only the device activities that fall inside its capture
# window, [the profiler's start, its stop] on the host's clock, and
# converts the card's timestamps to that clock.  A window of a few
# microsecond launches right after the start sits within the conversion's
# error of the edge, and all of it can be dropped.  So every window begins
# and ends with the card idle for this long.
PROFILE_PAD_S = 0.005


@contextlib.contextmanager
def profile_window():
    """torch.profiler over the block, CPU and CUDA activities, with the
    card idle for PROFILE_PAD_S on each side of the work inside it (the
    block's work is synchronized before the window closes); yields the
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def device_averages(prof) -> list:
    """The entries of ``prof.key_averages()`` that are device work: device
    time, and not a user annotation (the device-side shadow torch.profiler
    draws for a record_function range, such as the step's ``vpic.*``
    stages and replays, which would count its kernels twice)."""
    return [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def device(cpu: bool) -> torch.device:
    """The CPU when asked for, else the card; raises without one."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run the plain "
                           "versions on the CPU")
    return torch.device("cuda")


def cuda_ms(fn, n: int, setup=None) -> float:
    """ms per call of fn(): the best of WINDOWS windows of n calls between
    CUDA events, after one warm-up call.  With ``setup`` (for a call that
    changes its own input, such as the in-place merge), every call is
    preceded by setup() and timed on its own, outside setup's time."""
    if setup is not None:
        setup()
    fn()
    best = float("inf")
    for _ in range(WINDOWS):
        if setup is None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            best = min(best, start.elapsed_time(end) / n)
            continue
        total = 0.0
        for _ in range(n):
            setup()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        best = min(best, total / n)
    return best


def device_kernels(fn, n: int, setup=None) -> dict:
    """{kernel name: (launches, device ms)} per fn() call, from
    torch.profiler's device events over n calls after one warm-up call.
    With ``setup``, each call is preceded by setup() inside the window: its
    kernels are in the result too, so read the call's own by name."""
    if setup is not None:
        setup()
    fn()
    for _ in range(PROFILE_TRIES):
        with profile_window() as prof:
            for _ in range(n):
                if setup is not None:
                    setup()
                fn()
        got = {e.key: (e.count / n, e.device_time_total / 1e3 / n)
               for e in device_averages(prof)}
        if got:
            break
    return got


def kernel_device_ms(fn, kernel: str, n: int, setup=None) -> float:
    """Device ms per fn() call in the kernels whose name holds ``kernel``
    (with ``setup`` run before each call, as device_kernels); 0 where
    the profiler saw no such kernel in PROFILE_TRIES windows."""
    for _ in range(PROFILE_TRIES):
        ms = sum(ms for name, (_, ms) in device_kernels(fn, n, setup).items()
                 if kernel in name)
        if ms:
            break
    return ms


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
