"""Where the time of one harris step goes on the card.

    python -m vpic_tpu_torch.utils.step_breakdown [--deck harris2d|harris3d]
        [--graphed] [nx nppc]

Builds the harris deck on the GPU -- 2-D 64^2 x 64 ppc by default, or with
``--deck harris3d`` the 3-D residency deck at bench.py's widths (32^3 x 128
ppc, L = 16) -- and prints three things, each as one JSON line:

* ``layers_ms``: each layer of the step run on its own with CUDA events
  around it, mean ms over repeats.  2-D: sort, interpolator load, push,
  accumulator unload, field advance, cleaners, energies; the sort and
  cleaners run every time here though the step runs them only on their
  cadence; the field advance is what the step calls (``fields``, from
  ``Simulation.field_advance``: the fused field_beb kernel on these decks,
  named in ``field_advance``).  3-D adds the residency layers: the
  rebucket (the slack-padded brick sort, run by the step only when the
  exchange cannot merge), the
  rebucket's copy of its sort into the state's extent slices, the exchange
  plan (``residency.plan``: the csrc/res_plan.cu kernels) and the merge, in
  place as the step runs it; each 3-D push and merge runs on a fresh copy
  of the same lanes, made before the call and outside its time;
* ``step``: ms per step of the real step (host clock around synchronize),
  the device's busy share of that time from torch.profiler (kernel time
  summed / wall time), kernel launches per step, the host's
  ``cudaGraphLaunch`` calls and kernel-launch calls per step, field_beb
  launches per step and, in 3-D, rebuckets, merges and host syncs over the
  window.  The step is the eager one (``make_advance``), or with
  ``--graphed`` the graphed one (``make_step``, ``step_graph``; every
  cadence of the windows captured before them);
* ``kernels``: the kernels that took the most device time in that window.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..models import harris
from ..ops import field_fuse as FF
from ..ops import fields as F
from ..ops import fused_push as FP
from ..ops import fused_push3d as FP3
from ..ops import interp as I
from ..ops import push as P
from ..ops import residency as RES
from ..scripts import device_averages
from ..scripts import graph_checks as GC
from .. import step_graph as SG

REPS = 50


def _time(fn, reps=REPS, setup=None):
    """Mean ms of fn() between CUDA events, after two warm-up calls; with
    ``setup``, each call is preceded by an untimed setup() and timed on
    its own."""
    if setup is None:
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
    total = 0.0
    for rep in range(reps + 2):
        setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if rep >= 2:
            total += start.elapsed_time(end)
    return total / reps


def _common_layers(sim, state, species, qms, acc):
    g = sim.grid
    f = state.fields
    m = sim._material_coeffs()

    def unload():
        F.clear_jf(f)
        I.unload_accumulator(f, acc, g)
        F.synchronize_jf(f, g)

    trio, _ = sim.field_advance()

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

    return {
        "load_interpolator": _time(lambda: I.load_interpolator(f, g)),
        "unload": _time(unload),
        "fields": _time(lambda: trio(f, 0)),
        "cleaners": _time(cleaners),
        "energies": _time(lambda: sim.energies(state)),
    }


def _layers_2d(sim, state):
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    extents = [st.count for st in sim.species]
    species = [FP.bucket_sort_p(sp, g, extent=e)
               for sp, e in zip(state.species, extents)]
    fcoef = I.load_interpolator(state.fields, g)
    acc = torch.zeros((g.nv, 12), device="cuda")

    def push():
        acc.zero_()
        FP.fused_push_multi(species, fcoef, acc, g, qms)

    layers = {
        "sort": _time(lambda: [FP.bucket_sort_p(sp, g, extent=e)
                               for sp, e in zip(species, extents)]),
        "push": _time(push),
    }
    layers.update(_common_layers(sim, state, species, qms, acc))
    return layers


def _layers_3d(sim, state):
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    n0 = [st.count for st in sim.species]
    res_on, slack = sim._residency_mode()
    if not res_on:
        raise SystemExit("step_breakdown: this 3-D deck has no residency")
    exts = RES.extents(g, n0, slack)
    _, spid, usable = RES.static_layout(exts)
    sliced = [RES.slice_species(sp, E) for sp, E in zip(state.species, exts)]

    def rebucket():
        return [FP3.brick_sort_p_home(sp, g, extent=n, slack=slack)
                for sp, n in zip(sliced, n0)]

    out = rebucket()
    base = [o[0] for o in out]
    homes = [o[1] for o in out]
    fcoef = I.load_interpolator(state.fields, g)
    acc = torch.zeros((g.nv, 12), device="cuda")
    work = [sp.replace(**{n: getattr(sp, n).clone()
                          for n in FP3.LANE_FIELDS}) for sp in base]

    def fresh():
        for w, s in zip(work, base):
            for n in FP3.LANE_FIELDS:
                getattr(w, n).copy_(getattr(s, n))
        acc.zero_()

    def push():
        return FP3.fused_push3d_multi(work, fcoef, acc, g, qms, homes=homes,
                                      residency=True)

    fresh()
    pushed, _, emits, obx, ores, _ = push()
    pushed = [sp.replace(**{n: getattr(sp, n).clone()
                            for n in FP3.LANE_FIELDS}) for sp in pushed]

    def exchange():
        return RES.plan(pushed, emits, obx, ores, homes, spid, usable, g)

    compact, starts_j, a_j = exchange()[:3]
    merged = [sp.replace(**{n: getattr(sp, n).clone()
                            for n in FP3.LANE_FIELDS}) for sp in pushed]

    def restore():
        for m, p in zip(merged, pushed):
            for n in FP3.LANE_FIELDS:
                getattr(m, n).copy_(getattr(p, n))

    def merge():
        return RES.merge_p(merged, emits, compact, starts_j, a_j, merged)

    layers = {
        "rebucket": _time(rebucket),
        "push": _time(push, setup=fresh),
        "exchange": _time(exchange),
        "merge": _time(merge, setup=restore),
        "rebucket_copy": _time(lambda: [RES.copy_species(m, b) for m, b in
                                        zip(merged, base)]),
    }
    layers.update(_common_layers(sim, state, merged, qms, acc))
    return layers


def main(argv):
    ap = argparse.ArgumentParser(prog="step_breakdown")
    ap.add_argument("--deck", choices=("harris2d", "harris3d"),
                    default="harris2d")
    ap.add_argument("--graphed", action="store_true",
                    help="time the graphed step instead of the eager one")
    ap.add_argument("nx", nargs="?", type=int)
    ap.add_argument("nppc", nargs="?", type=float)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_breakdown: needs a CUDA device", file=sys.stderr)
        return 1
    three = args.deck == "harris3d"
    nx = args.nx or (32 if three else 64)
    nppc = args.nppc or (128.0 if three else 64.0)
    if three:
        p = harris.HarrisParams(nx=nx, ny=nx, nz=nx, nppc=nppc, Lx=nx / 2,
                                Ly=nx / 2, Lz=nx / 2)
    else:
        p = harris.HarrisParams(nx=nx, ny=nx, nppc=nppc, Lx=nx / 4,
                                Ly=nx / 4)
    sim = harris.build(p)
    state = sim.initialize()
    layers = (_layers_3d if three else _layers_2d)(sim, state)
    print(json.dumps({"deck": args.deck, "nx": nx, "nppc": nppc,
                      "field_advance": sim.field_advance()[1],
                      "layers_ms": layers}))

    # the real step, then a profiled window of it
    state = sim.initialize()
    n = 64
    if args.graphed:
        step = sim.make_step()
        if step.graphed is not True:
            raise SystemExit(f"step_breakdown: the step is not graphed: "
                             f"{step.graphed}")
        state = GC.warm_for(step, state, 2 * n)
    else:
        step = sim.make_advance()
        for _ in range(8):
            state = step(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state = step(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n

    SG.settle()
    reb0 = int(state.diag["_res_rebuckets"]) if three else 0
    RES.launches = 0
    FF.launches = 0
    sim.host_syncs = 0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3 / n
    SG.settle()
    calls = GC.host_launches(prof)
    kernels = [(e.key, e.device_time_total / 1e3 / n, e.count / n)
               for e in device_averages(prof)]
    busy = sum(k[1] for k in kernels)
    n_kernels = sum(k[2] for k in kernels)
    step_info = {
        "ms_per_step": wall_ms, "ms_per_step_profiled": prof_ms,
        "device_busy_ms_per_step": busy,
        "device_busy_share": busy / prof_ms if prof_ms else None,
        "kernels_per_step": n_kernels, "graphed": bool(args.graphed),
        "graph_launches_per_step": calls["graph"] / n,
        "host_kernel_launches_per_step": calls["kernel"] / n,
        "field_beb_per_step": FF.launches / n,
        "particles": sum(int(sp.np) for sp in state.species)}
    if three:
        step_info.update(
            window_steps=n,
            rebuckets=int(state.diag["_res_rebuckets"]) - reb0,
            merges=RES.launches, host_syncs=sim.host_syncs)
    print(json.dumps({"step": step_info}))
    kernels.sort(key=lambda k: -k[1])
    print(json.dumps({"kernels": [
        {"name": k[0][:80], "ms_per_step": k[1], "calls_per_step": k[2]}
        for k in kernels[:12]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
