"""Where the time of one harris step goes on the card.

    python -m vpic_tpu_torch.utils.step_breakdown [nx nppc]

Builds the 2-D harris deck (default 64^2 x 64 ppc) on the GPU and prints
three things, each as one JSON line:

* ``layers``: each layer of the step (sort, interpolator load, push,
  accumulator unload, field advance, cleaners, energies) run on its own
  with CUDA events around it, mean ms over repeats; the sort and cleaners
  run every step here though the step runs them only on their cadence;
* ``step``: ms per step of the real step (host clock around
  synchronize), and the device's busy share of that time from
  torch.profiler (kernel time summed / wall time);
* ``kernels``: the kernels that took the most device time in that window.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from ..models import harris
from ..ops import fields as F
from ..ops import fused_push as FP
from ..ops import interp as I
from ..ops import push as P

REPS = 50


def _time(fn, reps=REPS):
    """Mean ms of fn() between CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv):
    if not torch.cuda.is_available():
        print("step_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    nx, nppc = (int(argv[0]), float(argv[1])) if len(argv) >= 2 else (64, 64)
    p = harris.HarrisParams(nx=nx, ny=nx, nppc=nppc, Lx=nx / 4, Ly=nx / 4)
    sim = harris.build(p)
    sim.device = torch.device("cuda")
    state = sim.initialize()
    g = sim.grid
    f = state.fields
    qms = [(st.params.q, st.params.m) for st in sim.species]
    extents = [len(st.xs) for st in sim.species]
    species = [FP.bucket_sort_p(sp, g, extent=e)
               for sp, e in zip(state.species, extents)]
    fcoef = I.load_interpolator(f, g)
    acc = torch.zeros((g.nv, 12), device="cuda")
    m = sim._material_coeffs()

    def push():
        acc.zero_()
        FP.fused_push_multi(species, fcoef, acc, g, qms)

    def unload():
        F.clear_jf(f)
        I.unload_accumulator(f, acc, g)
        F.synchronize_jf(f, g)

    def advance_fields():
        F.advance_b(f, g, 0.5)
        F.advance_e(f, g, m, sim.damp)
        F.advance_b(f, g, 0.5)

    def cleaners():
        F.clear_rhof(f)
        rhof = f.rhof.reshape(-1)
        for sp, (q, _) in zip(species, qms):
            P.accumulate_rho_p(rhof, sp, g, q)
        F.synchronize_rho(f, g)
        for _ in range(sim.num_div_e_round):
            F.compute_div_e_err(f, g, m)
            F.clean_div_e(f, g, m)
        for _ in range(sim.num_div_b_round):
            F.compute_div_b_err(f, g)
            F.clean_div_b(f, g)
        F.synchronize_tang_e_norm_b(f, g)

    layers = {
        "sort": _time(lambda: [FP.bucket_sort_p(sp, g, extent=e)
                               for sp, e in zip(species, extents)]),
        "load_interpolator": _time(lambda: I.load_interpolator(f, g)),
        "push": _time(push),
        "unload": _time(unload),
        "fields": _time(advance_fields),
        "cleaners": _time(cleaners),
        "energies": _time(lambda: sim.energies(state)),
    }
    print(json.dumps({"layers_ms": layers}))

    # the real step, then a profiled window of it
    state = sim.initialize()
    step = sim.make_step()
    n = 64
    for _ in range(8):
        state = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state = step(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [(e.key, e.device_time_total / 1e3 / n, e.count / n)
               for e in prof.key_averages()
               if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy = sum(k[1] for k in kernels)
    n_kernels = sum(k[2] for k in kernels)
    print(json.dumps({"step": {
        "ms_per_step": wall_ms, "ms_per_step_profiled": prof_ms,
        "device_busy_ms_per_step": busy,
        "device_busy_share": busy / prof_ms if prof_ms else None,
        "kernels_per_step": n_kernels,
        "particles": sum(int(sp.np) for sp in state.species)}}))
    kernels.sort(key=lambda k: -k[1])
    print(json.dumps({"kernels": [
        {"name": k[0][:80], "ms_per_step": k[1], "calls_per_step": k[2]}
        for k in kernels[:12]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
