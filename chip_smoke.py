#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (vpic_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):
  1. device: a CUDA card is present; prints its nvidia-smi name and power
     limit;
  2. build: the six kernel sources (csrc/fused_push2d.cu, fused_push3d.cu,
     merge_p.cu, compact_block.cu with the compaction and the block copy,
     mailbox.cu, field_beb.cu) built for sm_90a, one nvcc each, started
     together; prints ptxas' registers / spills / shared memory, and the
     push kernels' CUDA blocks per SM;
  3. 2-D kernel: holds the 2-D push kernel against its plain PyTorch version
     on the 64^2 x 64 ppc harris state at the main path's shapes, after the
     bucket sort; prints its deposit rounds that took the global path and
     their share of all; times both with CUDA events, and the kernel's
     device time per push of both species with torch.profiler;
  4. 2-D reference: a small 2-D harris deck run 10 steps on the card and on
     the CPU (where the plain versions run) must agree;
  5. 2-D run: the full-width 2-D harris deck (64^2 cells x 64 ppc, 2 species
     of 131,072 particles) through Simulation's step for 200 steps; the push
     kernel (one launch a step for both species) must have been launched at
     least once a step, no streak may be left unfinished and the energy
     drift must stay below 1e-3 (bench.py's guard); prints the run's share
     of global-path deposit rounds; then 7 more steps, and the kernel
     against its plain version again on the last push before the next
     sort (the most global-path rounds);
  6. 3-D kernels: at the full-width 3-D harris state (32^3 cells x 128 ppc,
     2 species of 2,097,152 particles) after its first rebucket, the 3-D
     push kernel with its residency outbox against its plain version (with
     its global-path deposit rounds, and its device time as in phase 3),
     then the merge kernel against its plain version on that push's
     exchange plan (bit for bit); both timed with CUDA events;
  7. 3-D reference: a 16^3 harris deck run 10 steps on the card and on the
     CPU must agree;
  8. 3-D run: the full-width 3-D harris deck through the residency step for
     100 steps (bench.py --deck harris3d's widths and steps); both 3-D
     kernels must have been launched (the push once a step for both
     species, the merge once a step per species), no streak left
     unfinished, drift below 1e-3; prints the run's global-path share;
     then the kernel against its plain version again on the residency
     lanes and home maps the run left;
  9. residency prototypes: the entry points vpic_tpu_torch.scripts.
     residency_proto and residency_grid_bench (their main()), which hold the
     compaction kernel against numpy and its plain version bit for bit with
     equal counts at (9, 4096) and (16, 64 x 4096) (two entries of the
     kernels' line, one per entry point, each with its launches), the
     block copy (compact_blocks without a mask) at (16, 64 x 4096), and
     the mailbox kernel at 96 blocks of (16, 128), into a zeroed output
     and into a NaN-filled out=; and time kernel, plain version and
     library call (CUDA events), with the kernel's and the library call's
     device time;
 10. field trio: the entry point vpic_tpu_torch.scripts.field_fuse_proto
     (its main()) at the 64^2 x 4 ppc harris fields and at the 32^3 harris
     fields (4 ppc), fused kernel against the plain trio to 1e-6 abs on each
     output, exactly one launch per trio, both timed.
The kernel launch counts of each run are reset just before it and read just
after it.  Then it prints the kernels' JSON line, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}.
"""

import json
import os
import sys
import time

import numpy as np

N_STEPS = 200
N_STEPS_3D = 100
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_FLOPS = 67e12              # H100 SXM, float32 outside the tensor cores


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def bound_ms(bytes_moved, flops):
    """(least time in ms, what bounds it): bytes over the HBM rate against
    float32 operations over the card's float32 peak."""
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def lane_diff(torch, a, b):
    """Per live lane: voxels that differ.  Tolerance: at most 1 lane in 1e5
    may end in the neighbour cell, and only one that lies within 1e-5 of a
    face (FMA contraction); returns the (N,) bool mask of differing lanes."""
    live = a.live.cpu().numpy()
    n_live = int(live.sum())
    diff = live & (a.i.cpu().numpy() != b.i.cpu().numpy())
    if diff.sum() > max(1, n_live // 100_000):
        fail(f"{int(diff.sum())} of {n_live} voxels differ")
    for sp in (a, b):
        pos = np.stack([getattr(sp, n).cpu().numpy()[diff]
                        for n in ("dx", "dy", "dz")])
        gap = (1.0 - np.abs(pos)).min(axis=0) if diff.any() else []
        if np.any(np.asarray(gap) > 1e-5):
            fail("a differing voxel is not at a face")
    return diff


def compare_lanes(torch, k, a, b, diff):
    """Offsets and momenta of the live lanes whose voxel agrees, to 3e-5."""
    live = a.live.cpu().numpy()
    keep = live & ~diff
    err = 0.0
    for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
        x = getattr(a, n).cpu().numpy()[keep]
        y = getattr(b, n).cpu().numpy()[keep]
        e = float(np.abs(x - y).max()) if x.size else 0.0
        if e > 3e-5:
            fail(f"species {k}.{n}: max abs err {e} > 3e-5")
        err = max(err, e)
    print(f"  species {k}: {int(live.sum())} live lanes, {int(diff.sum())} "
          f"voxel(s) differ at a face")
    return err


def compare_acc(acc_k, acc_r):
    da, db = acc_k.cpu().numpy(), acc_r.cpu().numpy()
    e_acc = float(np.abs(da - db).max())
    scale = float(np.abs(db).max())
    print(f"  acc: max abs err {e_acc:.3e}, max |acc| {scale:.3e}")
    if e_acc > 1e-5 * max(scale, 1e-30):
        fail(f"acc: max abs err {e_acc} > 1e-5 * max|acc|")
    return e_acc


def global_share(mod, what):
    """Prints and returns the global-path deposit rounds counted by the
    push module ``mod`` since its count was reset, and their share."""
    glob, every = mod.deposits.tolist()
    share = glob / every if every else 0.0
    print(f"  deposits ({what}): {glob} of {every} rounds took the global "
          f"path ({100 * share:.4f} %)")
    return glob, share


def compare_push(torch, PT, FP, g, species, fcoef, qms, what):
    """2-D kernel vs plain version on the same inputs; returns the max abs
    error over the compared lane state and accumulator."""
    print(f"compare: 2-D kernel vs plain, {what}")
    zeros = lambda: torch.zeros((g.nv, 12), device=fcoef.device)
    FP.deposits = None
    sk, acc_k, unf_k = FP.fused_push_multi(PT.clone_species(species), fcoef,
                                           zeros(), g, qms)
    sr, acc_r, unf_r = FP.fused_push_multi_ref(PT.clone_species(species),
                                               fcoef, zeros(), g, qms)
    torch.cuda.synchronize()
    global_share(FP, what)
    if int(unf_k) != int(unf_r):
        fail(f"unfinished streaks: kernel {int(unf_k)} plain {int(unf_r)}")
    err = 0.0
    for k, (a, b) in enumerate(zip(sk, sr)):
        err = max(err, compare_lanes(torch, k, a, b, lane_diff(torch, a, b)))
    return max(err, compare_acc(acc_k, acc_r))


def compare_push3d(torch, PT, FP3, g, species, homes, fcoef, qms, what):
    """3-D kernel with its residency outbox vs plain version on the same
    inputs; returns (max abs error over the compared lane state, outbox
    rows and accumulator, the kernel's outputs)."""
    print(f"compare: 3-D kernel vs plain, {what} (residency outbox)")
    zeros = lambda: torch.zeros((g.nv, 12), device=fcoef.device)
    kw = dict(homes=homes, residency=True)
    FP3.deposits = None
    ker = FP3.fused_push3d_multi(PT.clone_species(species), fcoef, zeros(),
                                 g, qms, **kw)
    ref = FP3.fused_push3d_multi_ref(PT.clone_species(species), fcoef,
                                     zeros(), g, qms, **kw)
    torch.cuda.synchronize()
    global_share(FP3, what)
    (sk, acc_k, em_k, obx_k, ores_k, unf_k) = ker
    (sr, acc_r, em_r, obx_r, ores_r, unf_r) = ref
    if int(unf_k) != int(unf_r) or int(ores_k) != int(ores_r):
        fail(f"3-D: unfinished {int(unf_k)}/{int(unf_r)}, ores "
             f"{int(ores_k)}/{int(ores_r)} (kernel/plain)")
    err = 0.0
    blk0 = 0
    n_emit = 0
    for k, (a, b) in enumerate(zip(sk, sr)):
        diff = lane_diff(torch, a, b)
        err = max(err, compare_lanes(torch, k, a, b, diff))
        ea, eb = em_k[k].cpu().numpy(), em_r[k].cpu().numpy()
        if not np.array_equal(ea[~diff], eb[~diff]):
            fail(f"3-D species {k}: emit marks differ")
        n_emit += int(ea.sum())
        # outbox columns of every block whose lanes' voxels all agree
        nb = a.capacity // FP3.BLOCK
        ok_blk = ~diff.reshape(nb, FP3.BLOCK).any(1)
        cols = ((blk0 + np.nonzero(ok_blk)[0])[:, None] * FP3.OUT_CAP
                + np.arange(FP3.OUT_CAP)[None, :]).reshape(-1)
        for name in ("valid", "vox"):
            x = getattr(obx_k, name).cpu().numpy()[cols]
            y = getattr(obx_r, name).cpu().numpy()[cols]
            if not np.array_equal(x, y):
                fail(f"3-D species {k}: outbox {name} differs")
        e = float(np.abs(obx_k.f.cpu().numpy()[:, cols]
                         - obx_r.f.cpu().numpy()[:, cols]).max())
        if e > 3e-5:
            fail(f"3-D species {k}: outbox rows max abs err {e} > 3e-5")
        err = max(err, e)
        blk0 += nb
    err = max(err, compare_acc(acc_k, acc_r))
    print(f"  outbox: {n_emit} leavers emitted, {int(ores_k)} past the cap")
    return err, ker


def push_bytes(species, g, slots, extra=0):
    """Bytes a push must move: per live lane 8 words read and 7 written,
    a live flag per slot, the coefficient table, the accumulator in and
    out, plus ``extra``."""
    live = sum(int(sp.live.sum()) for sp in species)
    return (live * (32 + 28) + slots + g.nv * 72 + 2 * g.nv * 48 + extra,
            live * 150)


def small_reference(torch, harris, p, what):
    """10 steps of a small harris deck on the card and on the CPU (plain
    versions): fields to 5e-7 + 1e-5 max|a| (test_pallas.py:88-94),
    energies to 1e-6 of their sum, live counts equal."""
    runs = []
    for dev in ("cuda", "cpu"):
        sim = harris.build(p, device=dev)
        state = sim.run(num_step=10, verbose=False)
        runs.append((sim, state))
    (sim_gpu, gpu), (sim_cpu, cpu) = runs
    for n in ("jfx", "ex", "ey", "cbz"):
        a = getattr(cpu.fields, n).numpy()
        b = getattr(gpu.fields, n).cpu().numpy()
        if not np.abs(a - b).max() < 5e-7 + 1e-5 * np.abs(a).max():
            fail(f"{what}: field {n} differs from the CPU run")
    e_cpu = sim_cpu.energies(cpu).double().numpy()
    e_gpu = sim_gpu.energies(gpu).double().cpu().numpy()
    if not np.isfinite(e_gpu).all() or \
            np.abs(e_cpu - e_gpu).max() / e_cpu.sum() >= 1e-6:
        fail(f"{what}: energies {e_gpu} vs CPU {e_cpu}")
    for a, b in zip(cpu.species, gpu.species):
        if int(a.live.sum()) != int(b.live.sum()):
            fail(f"{what}: live counts differ")
    if int(gpu.diag["unfinished"]) != 0:
        fail(f"{what}: unfinished streaks on the card")
    print(f"reference: {what}, 10 steps on the card == CPU plain path "
          "(fields 5e-7 + 1e-5 max|a|, energies 1e-6 sum, live counts)")


def reset_counts(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def read_counts(counters):
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def run_steps(torch, sim, state, n_steps, counters):
    """n_steps of the deck's step with every kernel count set to 0 just
    before and read just after; returns (state, seconds, launches)."""
    step = sim.make_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(counters)
    sim.host_syncs = 0
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state = step(state)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return state, elapsed, read_counts(counters)


def check_run(torch, sim, state, e0, what):
    e1 = sim.energies(state).double().cpu().numpy()
    unfinished = int(state.diag["unfinished"])
    drift = abs(e1.sum() - e0.sum()) / e0.sum()
    if unfinished != 0:
        fail(f"{what}: {unfinished} streaks left unfinished")
    if not np.isfinite(e1).all():
        fail(f"{what}: non-finite energies")
    if not drift < 1e-3:
        fail(f"{what}: energy drift {drift}")
    for sp, st in zip(state.species, sim.species):
        if tuple(sp.dx.shape) != (st.params.capacity,) or \
                not torch.isfinite(sp.ux).all():
            fail(f"{what}: particle state has the wrong shape or "
                 "non-finite values")
    return drift, unfinished


def residency_prototypes(counters, card):
    """Phase 9: the entry points scripts.residency_proto and
    residency_grid_bench, each run with the kernel counts set to 0 just
    before and read just after; fails on a kernel not launched or a result
    that differs by a bit.  Returns the kernels' line entries by name."""
    from vpic_tpu_torch.ops import compact as C
    from vpic_tpu_torch.scripts import residency_grid_bench as RG
    from vpic_tpu_torch.scripts import residency_proto as RP

    results = {}
    reset_counts(counters)
    proto = RP.main([])
    launches = read_counts(counters)
    reset_counts(counters)
    grid = RG.main([])
    launches_grid = read_counts(counters)
    print(f"run prototypes: launches {launches} (residency_proto), "
          f"{launches_grid} (residency_grid_bench)")
    if launches[C.KERNEL] == 0 or launches[C.MAILBOX_KERNEL] == 0 or \
            launches_grid[C.KERNEL] == 0 or launches_grid[C.COPY_KERNEL] == 0:
        fail("a compaction, block copy or mailbox kernel was not launched")
    calls = {"compaction (9, 4096)": proto["compaction"],
             "compaction (16, 64 x 4096)": grid["compact"],
             "copy (16, 64 x 4096)": grid["copy"],
             "mailbox 96 x (16, 128)": proto["mailbox"],
             "mailbox into out=": proto["mailbox_out"]}
    if not all(c["bit_exact"] and c["max_abs_err"] == 0.0
               for c in calls.values()):
        fail("a prototype kernel differs from its plain version")
    for what, c in calls.items():
        if "ms" not in c:
            continue
        print(f"timing ({card}): {what}: kernel {c['ms']:.5f} ms (device "
              f"{c['device_ms']:.6f}), plain {c['plain_ms']:.5f}, library "
              f"{c['library_ms']:.5f} ms (device "
              f"{c['library_device_ms']:.6f}) per call; == plain and numpy, "
              "bit for bit (CUDA events, best of 3 windows; device time from "
              "torch.profiler)")
    for variant in ("copy", "compact"):
        c = grid[variant]
        print(f"timing ({card}): {variant} (16, 64 x 4096) after a 64 MB "
              f"write: kernel device {c['cold_device_ms']:.6f} ms, library "
              f"device {c['library_cold_device_ms']:.6f} ms")
    # bytes: each row read and written once, a float mask read once
    compactions = (
        (C.KERNEL, proto["compaction"], launches,
         "scripts/residency_proto.py:42"),
        (C.KERNEL + "_grid", grid["compact"], launches_grid,
         "scripts/residency_grid_bench.py:14, "
         "scripts/residency_grid_bench2.py:12"))
    for name, c, runs, where in compactions:
        R, Pn = c["shape"]
        bms, bby = bound_ms(2 * R * Pn * 4 + Pn * 4, 0)
        results[name] = dict(
            name=name, route="cuda",
            source="vpic_tpu_torch/csrc/compact_block.cu", replaces=where,
            launches=runs[C.KERNEL], max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=bms, bound_by=bby,
            library_ms=c["library_ms"])
    c = grid["copy"]
    R, Pn = c["shape"]
    bms, bby = bound_ms(2 * R * Pn * 4, 0)
    results[C.COPY_KERNEL] = dict(
        name=C.COPY_KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/compact_block.cu",
        replaces="scripts/residency_grid_bench.py:14 (make(False)), "
                 "scripts/residency_grid_bench2.py:12 (make('copy'))",
        launches=launches_grid[C.COPY_KERNEL], max_abs_err=c["max_abs_err"],
        ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=bms, bound_by=bby,
        library_ms=c["library_ms"])
    c = proto["mailbox"]
    R, M = c["shape"]
    bms, bby = bound_ms(2 * R * M * c["blocks"] * 4 + 4 * c["blocks"], 0)
    results[C.MAILBOX_KERNEL] = dict(
        name=C.MAILBOX_KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/mailbox.cu",
        replaces="scripts/residency_proto.py:110",
        launches=launches[C.MAILBOX_KERNEL],
        max_abs_err=max(c["max_abs_err"],
                        proto["mailbox_out"]["max_abs_err"]),
        ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=bms, bound_by=bby,
        library_ms=c["library_ms"])
    return results


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
    from vpic_tpu_torch.ops import compact as C
    from vpic_tpu_torch.ops import field_fuse as FF
    from vpic_tpu_torch.ops import fused_push as FP
    from vpic_tpu_torch.ops import fused_push3d as FP3
    from vpic_tpu_torch.ops import interp as I
    from vpic_tpu_torch.ops import residency as RES
    from vpic_tpu_torch.scripts import card as card_and_power
    from vpic_tpu_torch.scripts import cuda_ms
    from vpic_tpu_torch.scripts import field_fuse_proto as RF
    from vpic_tpu_torch.utils import push_timing as PT

    card = card_and_power()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = {FP.KERNEL: (FP, "launches"), FP3.KERNEL: (FP3, "launches"),
                RES.KERNEL: (RES, "launches"), C.KERNEL: (C, "launches"),
                C.COPY_KERNEL: (C, "copy_launches"),
                C.MAILBOX_KERNEL: (C, "mailbox_launches"),
                FF.KERNEL: (FF, "launches")}
    sources = [FP.KERNEL, FP3.KERNEL, RES.KERNEL, C.KERNEL, C.MAILBOX_KERNEL,
               FF.KERNEL]

    # --- phase 2: build every kernel, in parallel ---
    t0 = time.perf_counter()
    libs = _build.build_many(sources)
    print(f"build: {', '.join(lib.name for lib in libs)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for name in sources:
        log = _build.build_log(name)
        if "sm_90a" not in log:
            fail(f"{name} was not built for sm_90a")
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"  {name}: " + line.strip())
    per_sm = (FP._kernel_lib().fused_push2d_blocks_per_sm(),
              FP3._kernel_lib().fused_push3d_blocks_per_sm())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"occupancy: 1024-thread CUDA blocks per SM: fused_push2d "
          f"{per_sm[0]}, fused_push3d {per_sm[1]} (registers and the "
          f"deposit tile in shared memory; {sms} SMs)")
    results = {}

    # --- phase 3: 2-D kernel against its plain version ---
    sim = harris.build(harris.HarrisParams())
    t0 = time.perf_counter()
    state = sim.initialize()
    torch.cuda.synchronize()
    print(f"initialize: 64^2 x 64 ppc harris in "
          f"{time.perf_counter() - t0:.1f} s")
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    extents = [st.count for st in sim.species]
    sorted_sp = [FP.bucket_sort_p(sp, g, extent=e)
                 for sp, e in zip(state.species, extents)]
    fcoef = I.load_interpolator(state.fields, g)
    max_err = compare_push(torch, PT, FP, g, sorted_sp, fcoef, qms,
                           "first push after the sort")
    ms, plain_ms, ms2, plain_ms2 = (
        PT.time_push(fn, g, sorted_sp, fcoef, qms)
        for fn in (FP.fused_push_multi, FP.fused_push_multi_ref) * 2)
    dev_ms = PT.push_device_ms(FP.fused_push_multi, "fused_push2d_kernel",
                               g, sorted_sp, fcoef, qms)
    print(f"timing ({card}): 2-D kernel {ms:.4f} / {ms2:.4f} ms, plain "
          f"{plain_ms:.4f} / {plain_ms2:.4f} ms per push of both species "
          f"(CUDA events, mean of {PT.REPS}, order "
          "kernel-plain-kernel-plain); "
          f"kernel device time {dev_ms:.5f} ms per push of both species "
          f"(torch.profiler, {PT.REPS} pushes)")
    nbytes, flops = push_bytes(sorted_sp, g,
                               sum(sp.capacity for sp in sorted_sp))
    bms, bby = bound_ms(nbytes, flops)
    results[FP.KERNEL] = dict(
        name=FP.KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/fused_push2d.cu",
        replaces="vpic_tpu/ops/pallas_push.py:251", max_abs_err=max_err,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bby,
        library_ms=None)

    # --- phase 4: small 2-D deck against the CPU plain path ---
    small_reference(torch, harris, harris.HarrisParams(
        nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0), "16^2 x 4 ppc harris")

    # --- phase 5: the 2-D main path, 200 steps ---
    n_particles = sum(int(sp.np) for sp in state.species)
    e0 = sim.energies(state).double().cpu().numpy()
    FP.deposits = None
    state, elapsed, launches = run_steps(torch, sim, state, N_STEPS,
                                         counters)
    drift, unfinished = check_run(torch, sim, state, e0, "2-D run")
    global_share(FP, f"{N_STEPS} steps")
    rate = n_particles * N_STEPS / elapsed
    print(f"run 2-D: {N_STEPS} steps, {n_particles} particles, "
          f"{elapsed * 1e3 / N_STEPS:.3f} ms/step, {rate:.4e} pushes/s "
          f"({card}, host clock around synchronize)")
    print(f"run 2-D: launches {launches}, unfinished streaks {unfinished}, "
          f"host syncs {sim.host_syncs}, energy drift {drift:.3e}, max "
          "memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if launches[FP.KERNEL] < N_STEPS:
        fail(f"2-D push kernel launched {launches[FP.KERNEL]} times in "
             f"{N_STEPS} steps")
    results[FP.KERNEL]["launches"] = launches[FP.KERNEL]
    # 7 more steps (the first of them sorts): the lanes of the last push
    # before the next sort, where the most rounds take the global path
    step = sim.make_step()
    for _ in range(7):
        state = step(state)
    max_err = max(max_err, compare_push(
        torch, PT, FP, g, state.species, I.load_interpolator(state.fields, g),
        qms, f"{N_STEPS + 7} steps (7 pushes after a sort)"))
    results[FP.KERNEL]["max_abs_err"] = max_err
    del sim, state, sorted_sp, fcoef, step

    # --- phase 6: 3-D kernels against their plain versions ---
    p3 = harris.HarrisParams(nx=32, ny=32, nz=32, nppc=128, Lx=16.0,
                             Ly=16.0, Lz=16.0)
    t0 = time.perf_counter()
    sim = harris.build(p3)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = sim.initialize()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    g = sim.grid
    res_on, slack = sim._residency_mode()
    if not res_on:
        fail("the 32^3 x 128 ppc harris deck does not run residency")
    print(f"initialize: 32^3 x 128 ppc harris, deck build (host staging) "
          f"{t_build:.1f} s, initialize() {t_init:.1f} s; residency slack "
          f"{slack} blocks per brick")
    qms = [(st.params.q, st.params.m) for st in sim.species]
    n0 = [st.count for st in sim.species]
    exts = RES.extents(g, n0, slack)
    species, homes = [], []
    for sp, n, E in zip(state.species, n0, exts):
        s, h = FP3.brick_sort_p_home(RES.slice_species(sp, E), g, extent=n,
                                     slack=slack)
        species.append(s)
        homes.append(h)
    fcoef = I.load_interpolator(state.fields, g)
    kw = dict(homes=homes, residency=True)
    err3, ker = compare_push3d(torch, PT, FP3, g, species, homes, fcoef, qms,
                               "first push after the first rebucket")
    sk, _, em_k, obx_k, _, _ = ker
    ms3, plain3, ms3b, plain3b = (
        PT.time_push(fn, g, species, fcoef, qms, **kw)
        for fn in (FP3.fused_push3d_multi, FP3.fused_push3d_multi_ref) * 2)
    dev3 = PT.push_device_ms(FP3.fused_push3d_multi, "fused_push3d_kernel",
                             g, species, fcoef, qms, **kw)
    print(f"timing ({card}): 3-D kernel {ms3:.4f} / {ms3b:.4f} ms, plain "
          f"{plain3:.4f} / {plain3b:.4f} ms per push of both species "
          f"(CUDA events, mean of {PT.REPS}, order "
          "kernel-plain-kernel-plain); "
          f"kernel device time {dev3:.5f} ms per push of both species "
          f"(torch.profiler, {PT.REPS} pushes)")
    slots = sum(sp.capacity for sp in species)
    M = obx_k.vox.shape[0]
    nbytes, flops = push_bytes(species, g, slots,
                               extra=slots + M * 33 + 4 * (M // 128))
    bms, bby = bound_ms(nbytes, flops)
    results[FP3.KERNEL] = dict(
        name=FP3.KERNEL, route="cuda",
        source="vpic_tpu_torch/csrc/fused_push3d.cu",
        replaces="vpic_tpu/ops/pallas_push3d.py:369", max_abs_err=err3,
        ms=ms3, plain_ms=plain3, bound_ms=bms, bound_by=bby,
        library_ms=None)

    # the merge on the kernel push's exchange plan
    _, spid, usable = RES.static_layout(exts)
    free_j = RES.block_counts(sk, em_k)
    compact, starts_j, a_j, overflow, stats = RES.plan_exchange(
        obx_k, torch.cat(homes), spid, usable, free_j, g)
    if bool(overflow):
        fail("3-D: the first exchange plan overflows (the step would "
             "rebucket), so the merge would not run")
    mk = RES.merge_p(sk, em_k, compact, starts_j, a_j)
    mr = RES.merge_p_ref(sk, em_k, compact, starts_j, a_j)
    torch.cuda.synchronize()
    merge_err = 0.0
    for k, (a, b) in enumerate(zip(mk, mr)):
        for n in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w"):
            x, y = getattr(a, n), getattr(b, n)
            merge_err = max(merge_err, float(
                (x.double() - y.double()).abs().max()))
            if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
                fail(f"merge species {k}.{n}: kernel differs from plain")
        if not torch.equal(a.live, b.live) or int(a.np) != int(b.np):
            fail(f"merge species {k}: live lanes differ")
    routed = int(stats[0])
    print(f"compare: merge kernel == plain version in every lane, bit for "
          f"bit ({routed} rows routed, {int(a_j.sum())} placed)")
    merge = lambda: RES.merge_p(sk, em_k, compact, starts_j, a_j)
    merge_ref = lambda: RES.merge_p_ref(sk, em_k, compact, starts_j, a_j)
    merge_ms, merge_plain, merge_ms2, merge_plain2 = (
        cuda_ms(fn, PT.REPS) for fn in (merge, merge_ref, merge, merge_ref))
    print(f"timing ({card}): merge kernel {merge_ms:.4f} / {merge_ms2:.4f} "
          f"ms, plain {merge_plain:.4f} / {merge_plain2:.4f} ms per merge "
          f"of both species (CUDA events, best of 3 windows of {PT.REPS}, "
          "kernel-plain-kernel-plain)")
    # bytes: live + emit per slot, keepers' 8 words read, newcomers' 8
    # words read, starts and counts, every slot's 8 words + live written
    keepers = sum(int((s.live & ~e).sum()) for s, e in zip(sk, em_k))
    nbytes = (slots * 2 + keepers * 32 + int(a_j.sum()) * 32
              + 8 * a_j.shape[0] + slots * 33)
    bms, bby = bound_ms(nbytes, 0)
    results[RES.KERNEL] = dict(
        name=RES.KERNEL, route="cuda", source="vpic_tpu_torch/csrc/merge_p.cu",
        replaces="vpic_tpu/ops/residency.py:232", max_abs_err=merge_err,
        ms=merge_ms, plain_ms=merge_plain, bound_ms=bms, bound_by=bby,
        library_ms=None)
    del ker, sk, mk, mr, compact, species, fcoef

    # --- phase 7: small 3-D deck against the CPU plain path ---
    small_reference(torch, harris, harris.HarrisParams(
        nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0, headroom=6.0),
        "16^3 x 4 ppc harris (residency)")

    # --- phase 8: the 3-D residency path, 100 steps ---
    n_particles = sum(int(sp.np) for sp in state.species)
    e0 = sim.energies(state).double().cpu().numpy()
    FP3.deposits = None
    state, elapsed, launches = run_steps(torch, sim, state, N_STEPS_3D,
                                         counters)
    drift, unfinished = check_run(torch, sim, state, e0, "3-D run")
    global_share(FP3, f"{N_STEPS_3D} steps")
    rebuckets = int(state.diag["_res_rebuckets"])
    rate = n_particles * N_STEPS_3D / elapsed
    print(f"run 3-D: {N_STEPS_3D} steps, {n_particles} particles, "
          f"{elapsed * 1e3 / N_STEPS_3D:.3f} ms/step, {rate:.4e} pushes/s "
          f"({card}, host clock around synchronize)")
    print(f"run 3-D: launches {launches}, rebuckets {rebuckets}, host syncs "
          f"{sim.host_syncs}, unfinished streaks {unfinished}, energy drift "
          f"{drift:.3e}, max memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
          f"initialize() {t_init:.1f} s")
    nsp = len(state.species)
    if launches[FP3.KERNEL] < N_STEPS_3D:
        fail(f"3-D push kernel launched {launches[FP3.KERNEL]} times")
    if launches[RES.KERNEL] != nsp * (N_STEPS_3D - rebuckets) or \
            launches[RES.KERNEL] == 0:
        fail(f"merge kernel launched {launches[RES.KERNEL]} times with "
             f"{rebuckets} rebuckets in {N_STEPS_3D} steps")
    if sim.host_syncs != N_STEPS_3D:
        fail(f"{sim.host_syncs} host syncs in {N_STEPS_3D} steps")
    results[FP3.KERNEL]["launches"] = launches[FP3.KERNEL]
    results[RES.KERNEL]["launches"] = launches[RES.KERNEL]
    # the residency lanes and home maps the run left, kernel against plain
    err3, _ = compare_push3d(
        torch, PT, FP3, g, [RES.slice_species(sp, E)
                            for sp, E in zip(state.species, exts)],
        [state.diag[f"_chart_home{k}"] for k in range(nsp)],
        I.load_interpolator(state.fields, g), qms,
        f"{N_STEPS_3D} steps after the first rebucket")
    results[FP3.KERNEL]["max_abs_err"] = max(
        results[FP3.KERNEL]["max_abs_err"], err3)
    del sim, state

    # --- phase 9: the residency prototypes' entry points ---
    results.update(residency_prototypes(counters, card))

    # --- phase 10: the fused field trio's entry point ---
    reset_counts(counters)
    trio = [RF.main([]), RF.main(["--nx", "32", "--ny", "32", "--nz", "32"])]
    launches = read_counts(counters)
    calls = sum(r["kernel_calls"] for r in trio)
    print(f"run field trio: launches {launches}, {calls} fused trios")
    if launches[FF.KERNEL] != calls or calls == 0:
        fail(f"{launches[FF.KERNEL]} field_beb launches for {calls} trios")
    for r in trio:
        if not r["max_abs_err"] <= 1e-6:
            fail(f"field trio {r['shape']}: max abs err {r['max_abs_err']}")
        print(f"timing ({card}): field trio {r['shape']}: kernel "
              f"{r['ms'][0]:.5f} / {r['ms'][1]:.5f} ms (device "
              f"{r['device_ms']:.5f}), plain {r['plain_ms'][0]:.5f} / "
              f"{r['plain_ms'][1]:.5f} ms (device {r['plain_device_ms']:.5f})"
              f" per trio; launches per trio {r['launches_per_trio']} vs "
              f"plain {r['plain_launches_per_trio']}; max abs err "
              f"{r['max_abs_err']:.3e} (CUDA events, best of 3 windows of "
              "100, kernel-plain-kernel-plain)")
    r = trio[0]
    nvox = r["shape"][0] * r["shape"][1] * r["shape"][2]
    # 12 arrays read and 9 written; 81 float operations a voxel (3 x 6 in
    # each half advance_b, 3 x 15 in advance_e)
    bms, bby = bound_ms((12 + 9) * 4 * nvox, 81 * nvox)
    results[FF.KERNEL] = dict(
        name=FF.KERNEL, route="cuda", source="vpic_tpu_torch/csrc/field_beb.cu",
        replaces="scripts/field_fuse_proto.py:41",
        launches=launches[FF.KERNEL],
        max_abs_err=max(x["max_abs_err"] for x in trio), ms=r["ms"][0],
        plain_ms=r["plain_ms"][0], bound_ms=bms, bound_by=bby,
        library_ms=None)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
