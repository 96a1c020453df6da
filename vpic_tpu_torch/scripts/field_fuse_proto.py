"""The field trio advance_b(1/2), advance_e, advance_b(1/2) as one kernel on
the card (counterpart of ``scripts/field_fuse_proto.py``).

    python -m vpic_tpu_torch.scripts.field_fuse_proto [--cpu] [--nx 64]
        [--ny 64] [--nz 1]

Builds harris.HarrisParams(nx, ny, nz, nppc=4) -- 64^2 by default, the JAX
script's deck; the sides stay at 16 -- and initializes it.  From the
same initial fields it runs the fused kernel (ops/field_fuse.make_beb,
csrc/field_beb.cu) and the plain version (ops/field_fuse.beb_ref) once: the
9 outputs (E, cB and TCA, ghost planes included) must agree to
max |plain - fused| < 1e-6, the JAX script's own bound.  Then it times 100
trios of each in turns -- kernel, plain, plain, kernel (ms per trio, CUDA
events, best of 3 windows) -- then the device time per trio and the
launches per trio from torch.profiler over 100 more trios of each (the
kernel's launches also from its counter).  At these sizes the CUDA-event
times are set by the host, the device times by the kernels.

--cpu runs the plain trio only and checks that its outputs are finite.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from ..models import harris
from ..ops import field_fuse as FF
from . import card, cuda_ms, device, device_kernels, kernel_device_ms

TOL = 1e-6
TRIOS = 100
NPPC = 4.0          # the JAX script's particles per cell


def clone_fields(f):
    return dataclasses.replace(f, **{n.name: getattr(f, n.name).clone()
                                     for n in dataclasses.fields(f)})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="field_fuse_proto", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain trio only")
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    ap.add_argument("--nz", type=int, default=1)
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
    res = {"device": str(dev), "shape": list(g.shape), "nppc": NPPC,
           "damp": damp}
    if dev.type == "cpu":
        if not all(bool(torch.isfinite(getattr(plain, n)).all())
                   for n in FF.OUTPUTS):
            raise AssertionError("the plain trio gave non-finite fields")
        res["finite"] = True
        print(json.dumps(res))
        return res

    beb = FF.make_beb(g, m, damp)
    calls = 0
    count0 = FF.launches

    def run(f):
        nonlocal calls
        calls += 1
        return beb(f)

    fused = run(clone_fields(f0))
    torch.cuda.synchronize()
    errs = {n: float((getattr(plain, n) - getattr(fused, n)).abs().max())
            for n in FF.OUTPUTS}
    err = max(errs.values())
    if not err < TOL:
        raise AssertionError(f"max |plain - fused| = {err} >= {TOL}: {errs}")
    fp = clone_fields(f0)
    ref = lambda: FF.beb_ref(fp, g, m, damp)
    work = clone_fields(f0)
    fused_trio = lambda: run(work)
    ms, plain_ms = [], []
    # in turns: kernel, plain, plain, kernel
    for fn, out in ((fused_trio, ms), (ref, plain_ms), (ref, plain_ms),
                    (fused_trio, ms)):
        out.append(cuda_ms(fn, TRIOS))
    n0, c0 = FF.launches, calls
    device_ms = kernel_device_ms(fused_trio, "field_beb_grid_kernel", TRIOS)
    launches_per_trio = (FF.launches - n0) / (calls - c0)
    plain_k = device_kernels(ref, TRIOS).values()
    res.update(max_abs_err=err, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms,
               plain_device_ms=sum(t for _, t in plain_k),
               plain_launches_per_trio=sum(k for k, _ in plain_k),
               launches_per_trio=launches_per_trio, kernel_calls=calls,
               kernel_launches=FF.launches - count0, card=card())
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
