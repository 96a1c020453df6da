"""The two push kernels at the main path's shapes, against other checkouts
of the port, timed in turns on one card; and the push timers that
``chip_smoke.py`` uses too.

    python -m vpic_tpu_torch.utils.push_timing [--against DIR ...]

Makes the push inputs of both harris decks once, on the card, and keeps
them under ``build/push_timing/`` at the root of this checkout:

* ``2d-sorted``: 64^2 x 64 ppc, the lanes right after the bucket sort of
  the first step;
* ``2d-step7``: the lanes 7 steps later, the last push before the next sort;
* ``3d-rebucket``: 32^3 x 128 ppc, the residency lanes after the first
  rebucket (the slack-padded brick sort) and their home maps;
* ``3d-step50``: the residency lanes and home maps after 50 steps.

Then it runs one child process a turn, in the order ``turn_order`` gives:
each DIR, this checkout twice, then each DIR again in reverse order.  A
child imports the port of its own checkout (``python -P`` with that
checkout on ``PYTHONPATH``) and runs this file's timers on it: it builds
that checkout's push kernels, loads the inputs and, for each, pushes both
species, REPS times for the kernel's device ms per push (``push_device_ms``)
and REPS times for the CUDA-event ms (``time_push``).  It keeps the lane
state one push leaves (lanes, and in 3-D the emit marks, the outbox,
``ores`` and ``unfinished``) and the accumulator, and prints one JSON line.
The first process prints each child's line, then one summary line per
input: the turns' times in order and, for each turn against this
checkout's first, the lane-state arrays that differ (``differ``) and the
largest accumulator difference over max|acc|.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
INPUTS = ROOT / "build" / "push_timing"
CASES = ("2d-sorted", "2d-step7", "3d-rebucket", "3d-step50")
KERNELS = {"2d": "fused_push2d_kernel", "3d": "fused_push3d_kernel"}
LANES = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live", "np")
MOVED = LANES[:9]                       # the arrays a push writes (w and
                                        # live where a wall kills a lane)
REPS = 20                               # pushes per timing


def clone_species(species):
    return [sp.replace(**{n: getattr(sp, n).clone() for n in LANES})
            for sp in species]


class Pusher:
    """Pushes every species with ``fn`` on a working copy of the same input
    lanes: ``fresh()`` restores the copy and zeroes the accumulator,
    ``push()`` pushes it."""

    def __init__(self, fn, g, species, fcoef, qms, **kw):
        self.fn, self.g, self.species, self.fcoef, self.qms, self.kw = (
            fn, g, species, fcoef, qms, kw)
        self.work = clone_species(species)
        self.acc = torch.zeros((g.nv, 12), dtype=torch.float32,
                               device=fcoef.device)

    def fresh(self):
        for w, s in zip(self.work, self.species):
            for n in MOVED:
                getattr(w, n).copy_(getattr(s, n))
        self.acc.zero_()

    def push(self):
        return self.fn(self.work, self.fcoef, self.acc, self.g, self.qms,
                       **self.kw)


def time_push(fn, g, species, fcoef, qms, **kw):
    """Mean ms of one push of every species: CUDA events around each of
    REPS pushes after two warm-up pushes, each on a fresh copy of the same
    input lanes (restored outside the events)."""
    p = Pusher(fn, g, species, fcoef, qms, **kw)
    total = 0.0
    for rep in range(REPS + 2):
        p.fresh()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p.push()
        end.record()
        torch.cuda.synchronize()
        if rep >= 2:
            total += start.elapsed_time(end)
    return total / REPS


def push_device_ms(fn, kernel, g, species, fcoef, qms, **kw):
    """Device ms per push of every species in the kernels whose name holds
    ``kernel`` (torch.profiler over REPS pushes), each push on a fresh copy
    of the same input lanes."""
    # absolute: a turn's child runs this file as a script
    from vpic_tpu_torch.scripts import kernel_device_ms
    p = Pusher(fn, g, species, fcoef, qms, **kw)

    def push():
        p.fresh()
        p.push()

    return kernel_device_ms(push, kernel, REPS)


def turn_order(here: str, others) -> list:
    """The checkouts in turns: each other one, this one twice, then the
    others again in reverse (one other: other, here, here, other)."""
    others = list(others)
    return others + [here, here] + others[::-1]


def differ(a: dict, b: dict) -> dict:
    """{array: [elements that differ in any bit, largest abs difference]}
    over the lane-state arrays (not the accumulator, ``acc``) that differ."""
    out = {}
    for n, x in a.items():
        if n == "acc":
            continue
        y = b[n]
        if x.dtype == torch.float32:
            bits = x.view(torch.int32) != y.view(torch.int32)
        else:
            bits = x != y
        if bits.any():
            out[n] = [int(bits.sum()),
                      float((x.double() - y.double()).abs().max())]
    return out


def _save(case, g, species, fcoef, qms, homes=None):
    torch.save({"g": dict(g.__dict__), "qms": list(qms), "homes": homes and
                [h.cpu() for h in homes], "fcoef": fcoef.cpu(),
                "species": [{n: getattr(sp, n).cpu() for n in LANES}
                            for sp in species]}, INPUTS / f"{case}.pt")


def make_inputs():
    """The four push inputs, from this checkout's decks on the card."""
    from ..models import harris
    from ..ops import fused_push as FP
    from ..ops import fused_push3d as FP3
    from ..ops import interp as I
    from ..ops import residency as RES

    INPUTS.mkdir(parents=True, exist_ok=True)
    sim = harris.build(harris.HarrisParams())
    state = sim.initialize()
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    sorted_sp = [FP.bucket_sort_p(sp, g, extent=st.count)
                 for sp, st in zip(state.species, sim.species)]
    _save("2d-sorted", g, sorted_sp, I.load_interpolator(state.fields, g),
          qms)
    step = sim.make_step()
    for _ in range(7):
        state = step(state)
    _save("2d-step7", g, state.species, I.load_interpolator(state.fields, g),
          qms)

    sim = harris.build(harris.HarrisParams(nx=32, ny=32, nz=32, nppc=128,
                                           Lx=16.0, Ly=16.0, Lz=16.0))
    state = sim.initialize()
    g = sim.grid
    qms = [(st.params.q, st.params.m) for st in sim.species]
    res_on, slack = sim._residency_mode()
    if not res_on:
        raise SystemExit("push_timing: the 3-D deck does not run residency")
    n0 = [st.count for st in sim.species]
    exts = RES.extents(g, n0, slack)
    out = [FP3.brick_sort_p_home(RES.slice_species(sp, E), g, extent=n,
                                 slack=slack)
           for sp, n, E in zip(state.species, n0, exts)]
    _save("3d-rebucket", g, [o[0] for o in out],
          I.load_interpolator(state.fields, g), qms, [o[1] for o in out])
    step = sim.make_step()
    for _ in range(50):
        state = step(state)
    _save("3d-step50", g, [RES.slice_species(sp, E)
                           for sp, E in zip(state.species, exts)],
          I.load_interpolator(state.fields, g), qms,
          [state.diag[f"_chart_home{k}"] for k in range(len(exts))])
    torch.cuda.synchronize()


def child(turn: int) -> dict:
    """One turn: the vpic_tpu_torch of the checkout on PYTHONPATH pushes
    every input."""
    import vpic_tpu_torch.ops.fused_push as FP
    import vpic_tpu_torch.ops.fused_push3d as FP3
    from vpic_tpu_torch.grid import Grid
    from vpic_tpu_torch.ops import _build
    from vpic_tpu_torch.scripts import card
    from vpic_tpu_torch.state import SpeciesState

    _build.build_many([FP.KERNEL, FP3.KERNEL])
    dev = torch.device("cuda")
    row = {"turn": turn, "checkout": str(Path(FP.__file__).parents[2]),
           "card": card(), "cases": {}}
    for case in CASES:
        d = torch.load(INPUTS / f"{case}.pt", weights_only=False)
        g = Grid(**d["g"])
        qms = [tuple(x) for x in d["qms"]]
        fcoef = d["fcoef"].to(dev)
        species = [SpeciesState(**{n: t.to(dev) for n, t in s.items()})
                   for s in d["species"]]
        three = case.startswith("3d")
        kw = ({"homes": [h.to(dev) for h in d["homes"]], "residency": True}
              if three else {})
        fn = FP3.fused_push3d_multi if three else FP.fused_push_multi
        p = Pusher(fn, g, species, fcoef, qms, **kw)
        p.fresh()
        out = p.push()
        state = {f"{k}.{n}": getattr(sp, n) for k, sp in enumerate(out[0])
                 for n in MOVED}
        if three:
            state.update({f"emit{k}": e for k, e in enumerate(out[2])})
            state.update(zip(("obx.f", "obx.vox", "obx.valid"), out[3]))
            state.update(ores=out[4], unfinished=out[5])
        else:
            state["unfinished"] = out[2]
        state["acc"] = p.acc
        torch.save({n: t.cpu() for n, t in state.items()},
                   INPUTS / f"out-{turn}-{case}.pt")
        row["cases"][case] = {
            "device_ms": push_device_ms(fn, KERNELS[case[:2]], g, species,
                                        fcoef, qms, **kw),
            "event_ms": time_push(fn, g, species, fcoef, qms, **kw)}
    return row


def main(argv):
    ap = argparse.ArgumentParser(prog="push_timing")
    ap.add_argument("--against", nargs="+", default=[],
                    help="other checkouts of the port")
    ap.add_argument("--child", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("push_timing: needs a CUDA device", file=sys.stderr)
        return 1
    if args.child is not None:
        print(json.dumps(child(args.child)))
        return 0
    make_inputs()
    torch.cuda.empty_cache()
    others = [str(Path(d).resolve()) for d in args.against]
    turns = turn_order(str(ROOT), others)
    rows = []
    for turn, tree in enumerate(turns):
        env = dict(os.environ, PYTHONPATH=tree)
        proc = subprocess.run(
            [sys.executable, "-P", str(Path(__file__).resolve()), "--child",
             str(turn)], cwd=tree, env=env, capture_output=True, text=True,
            timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise SystemExit(f"push_timing: turn {turn} ({tree}) failed")
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]))
    ref = len(others)                   # this checkout's first turn
    for case in CASES:
        outs = [torch.load(INPUTS / f"out-{t}-{case}.pt")
                for t in range(len(turns))]
        scale = float(outs[ref]["acc"].abs().max())
        print(json.dumps({
            "case": case, "checkouts": turns,
            **{key: [r["cases"][case][key] for r in rows]
               for key in ("device_ms", "event_ms")},
            "lanes_differ": [differ(o, outs[ref]) for o in outs],
            "acc_diff_rel": [float((o["acc"] - outs[ref]["acc"]).abs().max())
                             / scale for o in outs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
