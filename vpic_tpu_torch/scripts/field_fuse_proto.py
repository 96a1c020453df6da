"""The field trio advance_b(1/2), advance_e, advance_b(1/2) as one kernel on
the card (counterpart of ``scripts/field_fuse_proto.py``).

    python -m vpic_tpu_torch.scripts.field_fuse_proto [--cpu] [--nx 64]
        [--ny 64] [--nz 1] [--parent DIR]

Builds harris.HarrisParams(nx, ny, nz, nppc=4) -- 64^2 by default, the JAX
script's deck; the sides stay at 16 -- and initializes it.  From the
same initial fields it runs each instance of the fused kernel
(ops/field_fuse.make_beb, csrc/field_beb.cu) that takes this grid -- the
grid instance (the step's) always, the cluster instance where its slabs
fit -- and the plain version (ops/field_fuse.beb_ref) once: the 9 outputs (E, cB and TCA,
ghost planes included) must agree to max |plain - fused| < 1e-6, the JAX
script's own bound.  Then it times 100 trios of each in turns -- the
instances, the plain trio, the plain trio, the instances in reverse
order (ms per trio, CUDA events, best of 3 windows) -- then the device
time per trio and the launches per trio from torch.profiler over 100 more
trios of each (the kernel's launches also from its counter).  At these
sizes the CUDA-event times are set by the host, the device times by the
kernels.

--parent DIR also builds DIR's csrc/field_beb.cu (another checkout of the
port whose kernel has the one-launch ``field_beb`` C entry, such as the
commit before the cluster instance) into build/kernels/ and runs it on the
same inputs and arguments: its outputs must equal the plain trio's to the
same bound, and it is timed first and last in the turns.

--cpu runs the plain trio only and checks that its outputs are finite.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..models import harris
from ..ops import _build
from ..ops import field_fuse as FF
from . import card, cuda_ms, device, device_kernels, kernel_device_ms

TOL = 1e-6
TRIOS = 100
NPPC = 4.0          # the JAX script's particles per cell


def clone_fields(f):
    return dataclasses.replace(f, **{n.name: getattr(f, n.name).clone()
                                     for n in dataclasses.fields(f)})


def parent_trio(tree: str, g, m, damp):
    """The parent checkout's kernel as ``trio(f)``, with the coefficient and
    face arguments this checkout's kernel takes for g, m and damp:
    DIR/vpic_tpu_torch/csrc/field_beb.cu built with this checkout's nvcc
    flags."""
    csrc = Path(tree) / "vpic_tpu_torch" / "csrc"
    lib_path = _build.BUILD_DIR / "parent-field_beb.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(lib_path), str(csrc / "field_beb.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).field_beb
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    c_coef, c_faces = FF.kernel_args(g, m, damp)

    def trio(f):
        rc = fn(*(getattr(f, n).data_ptr() for n in FF.FIELDS), g.nx, g.ny,
                g.nz, c_coef, c_faces, FF.THREADS,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent field_beb launch failed ({rc})")
        return f

    return trio


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="field_fuse_proto", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain trio only")
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=1)
    ap.add_argument("--parent", help="another checkout of the port")
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    sim = harris.build(harris.HarrisParams(nx=args.nx, ny=args.ny,
                                           nz=args.nz, nppc=NPPC),
                       device=dev)
    f0 = sim.initialize().fields
    g = sim.grid
    m = sim._material_coeffs()
    damp = sim.damp
    plain = FF.beb_ref(clone_fields(f0), g, m, damp)
    cells = (g.nx, g.ny, g.nz)
    res = {"device": str(dev), "shape": list(g.shape), "nppc": NPPC,
           "damp": damp}
    if dev.type == "cpu":
        if not all(bool(torch.isfinite(getattr(plain, n)).all())
                   for n in FF.OUTPUTS):
            raise AssertionError("the plain trio gave non-finite fields")
        res["finite"] = True
        print(json.dumps(res))
        return res

    chosen = FF.make_beb(g, m, damp).instance
    names = [chosen] + (["cluster"] if FF.cluster_fits(cells) else [])
    trios = {w: FF.make_beb(g, m, damp, w) for w in names}
    if args.parent:
        trios["parent"] = parent_trio(args.parent, g, m, damp)
    calls = 0
    count0 = FF.launches
    kernel_name = {"cluster": "field_beb_cluster_kernel",
                   "grid": "field_beb_grid_kernel",
                   "parent": "field_beb_kernel"}

    def counted(fn):
        def call(f):
            nonlocal calls
            calls += 1
            return fn(f)
        return call

    runs = {w: counted(fn) if w != "parent" else fn
            for w, fn in trios.items()}
    out = {}
    for w, fn in runs.items():
        fused = fn(clone_fields(f0))
        torch.cuda.synchronize()
        errs = {n: float((getattr(plain, n) - getattr(fused, n)).abs().max())
                for n in FF.OUTPUTS}
        err = max(errs.values())
        if not err < TOL:
            raise AssertionError(f"{w}: max |plain - fused| = {err} >= "
                                 f"{TOL}: {errs}")
        out[w] = {"max_abs_err": err}
    fp = clone_fields(f0)
    ref = lambda: FF.beb_ref(fp, g, m, damp)
    work = {w: clone_fields(f0) for w in runs}
    # in turns: (parent,) instances, plain, plain, instances, (parent)
    order = ([w for w in runs if w == "parent"]
             + [w for w in runs if w != "parent"])
    times = {w: [] for w in order}
    plain_ms = []
    for turn in (order, ["plain", "plain"], order[::-1]):
        for w in turn:
            if w == "plain":
                plain_ms.append(cuda_ms(ref, TRIOS))
            else:
                times[w].append(cuda_ms(lambda: runs[w](work[w]), TRIOS))
    for w in order:
        n0, c0 = FF.launches, calls
        out[w].update(ms=times[w], device_ms=kernel_device_ms(
            lambda: runs[w](work[w]), kernel_name[w], TRIOS))
        if w != "parent":
            out[w]["launches_per_trio"] = (FF.launches - n0) / (calls - c0)
    plain_k = device_kernels(ref, TRIOS).values()
    res.update(instance=chosen, instances=out,
               max_abs_err=max(out[w]["max_abs_err"] for w in names),
               ms=out[chosen]["ms"], device_ms=out[chosen]["device_ms"],
               plain_ms=plain_ms,
               plain_device_ms=sum(ms for _, ms in plain_k),
               plain_launches_per_trio=sum(n for n, _ in plain_k),
               launches_per_trio=out[chosen]["launches_per_trio"],
               kernel_calls=calls,
               kernel_launches=FF.launches - count0, card=card())
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
