#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (vpic_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. device: a CUDA card is present; prints its nvidia-smi name and power
     limit;
  2. kernels: builds csrc/fused_push2d.cu for sm_90a (printing ptxas'
     registers / spills / shared memory), then holds the kernel against its
     plain PyTorch version on the same 64^2 x 64 ppc harris state at the
     main path's shapes, and times both with CUDA events;
  3. reference: a small harris deck run 10 steps on the card and on the CPU
     (where the plain version runs) must agree;
  4. the run: the full-width 2-D harris deck (64^2 cells x 64 ppc, 2 species
     of 131,072 particles) through Simulation's step for 200 steps; the push
     kernel must have been launched, no streak may be left unfinished and the
     energy drift must stay below 1e-3 (bench.py's guard).
Then it prints the kernels' JSON line, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

N_STEPS = 200
REPS = 20


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def clone_species(species):
    return [sp.replace(**{n: getattr(sp, n).clone() for n in
                          ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w",
                           "live", "np")})
            for sp in species]


def compare_push(torch, FP, g, species, fcoef, qms):
    """Kernel vs plain version on the same inputs; returns the max abs
    error over the compared lane state and accumulator."""
    sk, acc_k, unf_k = FP.fused_push_multi(
        clone_species(species), fcoef,
        torch.zeros((g.nv, 12), dtype=torch.float32, device=fcoef.device),
        g, qms)
    sr, acc_r, unf_r = FP.fused_push_multi_ref(
        clone_species(species), fcoef,
        torch.zeros((g.nv, 12), dtype=torch.float32, device=fcoef.device),
        g, qms)
    torch.cuda.synchronize()
    if int(unf_k) != int(unf_r):
        fail(f"unfinished streaks: kernel {int(unf_k)} plain {int(unf_r)}")
    err = 0.0
    for k, (a, b) in enumerate(zip(sk, sr)):
        live = a.live.cpu().numpy()
        n_live = int(live.sum())
        ia, ib = a.i.cpu().numpy()[live], b.i.cpu().numpy()[live]
        diff = ia != ib
        # tolerance: at most 1 lane in 1e5 may end in the neighbour cell,
        # and only one that lies within 1e-5 of a face (FMA contraction)
        if diff.sum() > max(1, n_live // 100_000):
            fail(f"species {k}: {int(diff.sum())} of {n_live} voxels differ")
        for sp in (a, b):
            pos = np.stack([getattr(sp, n).cpu().numpy()[live][diff]
                            for n in ("dx", "dy", "dz")])
            gap = (1.0 - np.abs(pos)).min(axis=0) if diff.any() else []
            if np.any(np.asarray(gap) > 1e-5):
                fail(f"species {k}: a differing voxel is not at a face")
        for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
            x = getattr(a, n).cpu().numpy()[live][~diff]
            y = getattr(b, n).cpu().numpy()[live][~diff]
            e = float(np.abs(x - y).max()) if x.size else 0.0
            if e > 3e-5:
                fail(f"species {k}.{n}: max abs err {e} > 3e-5")
            err = max(err, e)
        print(f"  species {k}: {n_live} live lanes, {int(diff.sum())} "
              f"voxel(s) differ at a face")
    da, db = acc_k.cpu().numpy(), acc_r.cpu().numpy()
    e_acc = float(np.abs(da - db).max())
    scale = float(np.abs(db).max())
    print(f"  acc: max abs err {e_acc:.3e}, max |acc| {scale:.3e}")
    if e_acc > 1e-5 * max(scale, 1e-30):
        fail(f"acc: max abs err {e_acc} > 1e-5 * max|acc|")
    return max(err, e_acc)


def time_push(torch, fn, g, species, fcoef, qms):
    """Mean ms of one push of every species, CUDA events around each call,
    each on a fresh copy of the same input lanes."""
    acc = torch.zeros((g.nv, 12), dtype=torch.float32, device=fcoef.device)
    work = clone_species(species)
    total = 0.0
    for rep in range(REPS + 2):
        for w, s in zip(work, species):
            for n in ("dx", "dy", "dz", "i", "ux", "uy", "uz"):
                getattr(w, n).copy_(getattr(s, n))
        acc.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(work, fcoef, acc, g, qms)
        end.record()
        torch.cuda.synchronize()
        if rep >= 2:                    # two warm-up calls
            total += start.elapsed_time(end)
    return total / REPS


def small_reference(torch, harris):
    """10 steps of a small harris deck on the card and on the CPU (plain
    version); fields to test_pallas.py's tolerances."""
    p = harris.HarrisParams(nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0)
    runs = []
    for dev in ("cuda", "cpu"):
        sim = harris.build(p)
        sim.device = torch.device(dev)
        state = sim.run(num_step=10, verbose=False)
        runs.append((sim, state))
    (sim_gpu, gpu), (sim_cpu, cpu) = runs
    for n in ("jfx", "ex", "ey", "cbz"):
        a = getattr(cpu.fields, n).numpy()
        b = getattr(gpu.fields, n).cpu().numpy()
        if not np.abs(a - b).max() < 5e-7 + 1e-5 * np.abs(a).max():
            fail(f"small deck: field {n} differs from the CPU run")
    e_cpu = sim_cpu.energies(cpu).double().numpy()
    e_gpu = sim_gpu.energies(gpu).double().cpu().numpy()
    if not np.isfinite(e_gpu).all() or \
            np.abs(e_cpu - e_gpu).max() / e_cpu.sum() >= 1e-6:
        fail(f"small deck: energies {e_gpu} vs CPU {e_cpu}")
    print("reference: 16^2 x 4 ppc harris, 10 steps on the card == CPU "
          "plain path (fields 5e-7 + 1e-5 max|a|, energies 1e-6 sum)")


def main():
    import torch

    # --- phase 1: device ---
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: the port's smoke test needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vpic_tpu_torch.models import harris
    from vpic_tpu_torch.ops import _build
    from vpic_tpu_torch.ops import fused_push as FP
    from vpic_tpu_torch.ops import interp as I

    card = gpu_name_and_power()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 2: build, launch, compare with the plain version ---
    t0 = time.perf_counter()
    lib = _build.build(FP.KERNEL)
    log = _build.build_log(FP.KERNEL)
    if "sm_90a" not in log:
        fail("kernel was not built for sm_90a")
    print(f"build: {lib.name} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas info" in line or "spill" in line:
            print("  " + line.strip())

    sim = harris.build(harris.HarrisParams())
    sim.device = torch.device("cuda")
    t0 = time.perf_counter()
    state = sim.initialize()
    torch.cuda.synchronize()
    print(f"initialize: 64^2 x 64 ppc harris in "
          f"{time.perf_counter() - t0:.1f} s")
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    extents = [len(st.xs) for st in sim.species]
    sorted_sp = [FP.bucket_sort_p(sp, g, extent=e)
                 for sp, e in zip(state.species, extents)]
    fcoef = I.load_interpolator(state.fields, g)
    print("compare: kernel vs plain, first push of the run (sorted lanes)")
    max_err = compare_push(torch, FP, g, sorted_sp, fcoef, qms)
    ms = time_push(torch, FP.fused_push_multi, g, sorted_sp, fcoef, qms)
    plain_ms = time_push(torch, FP.fused_push_multi_ref, g, sorted_sp,
                         fcoef, qms)
    ms2 = time_push(torch, FP.fused_push_multi, g, sorted_sp, fcoef, qms)
    plain_ms2 = time_push(torch, FP.fused_push_multi_ref, g, sorted_sp,
                          fcoef, qms)
    print(f"timing ({card}): kernel {ms:.4f} / {ms2:.4f} ms, plain "
          f"{plain_ms:.4f} / {plain_ms2:.4f} ms per push of both species "
          f"(CUDA events, mean of {REPS}, order kernel-plain-kernel-plain)")

    # --- phase 3: small deck against the CPU plain path ---
    small_reference(torch, harris)

    # --- phase 4: the main path, 200 steps ---
    n_particles = sum(int(sp.np) for sp in state.species)
    e0 = sim.energies(state).double().cpu().numpy()
    step = sim.make_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FP.launches = 0
    t0 = time.perf_counter()
    for _ in range(N_STEPS):
        state = step(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = FP.launches
    e1 = sim.energies(state).double().cpu().numpy()
    unfinished = int(state.diag["unfinished"])
    drift = abs(e1.sum() - e0.sum()) / e0.sum()
    rate = n_particles * N_STEPS / elapsed
    print(f"run: {N_STEPS} steps, {n_particles} particles, "
          f"{elapsed * 1e3 / N_STEPS:.3f} ms/step, {rate:.4e} pushes/s "
          f"({card}, host clock around synchronize)")
    print(f"run: push kernel launches {launches}, unfinished streaks "
          f"{unfinished}, energy drift {drift:.3e}, max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if launches < N_STEPS:
        fail(f"push kernel launched {launches} times in {N_STEPS} steps")
    if unfinished != 0:
        fail(f"{unfinished} streaks left unfinished")
    if not np.isfinite(e1).all():
        fail("non-finite energies")
    if not drift < 1e-3:
        fail(f"energy drift {drift} over {N_STEPS} steps")
    for sp, st in zip(state.species, sim.species):
        if tuple(sp.dx.shape) != (st.params.capacity,) or \
                not torch.isfinite(sp.ux).all():
            fail("particle state has the wrong shape or non-finite values")

    print(json.dumps({"kernels": [{
        "name": FP.KERNEL, "route": "cuda",
        "source": "vpic_tpu_torch/csrc/fused_push2d.cu",
        "replaces": "vpic_tpu/ops/pallas_push.py:251",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
