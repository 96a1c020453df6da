"""The cleaners' charge deposit (``ops/rho_p.accumulate_rho_multi``, the
``csrc/rho_p.cu`` kernel) against its plain version on the card, on the
states of the benchmark's decks:

    python -m vpic_tpu_torch.scripts.rho_bench

harris3d (32^3 x 128 ppc, the residency layout with its home maps: the
kernel's TILE instance), sc08 (150 x 25 x 100 x 1 ppc, the general path:
no home maps) and harris2d (64^2 x 64 ppc), each a few graphed steps after
``initialize()``, as the cleaners find them.  For each: the step's path,
its cleaning steps and the kernel's launches in initialize() and those
steps (none in initialize(), which keeps the plain version, and one a
cleaning step for every species); the kernel's rhof against the plain
version's, over the charge scale (the larger of max |rhof| and one
species' largest node charge: ions and electrons loaded in pairs leave a
net charge below either's, so max |rhof| alone would hold rounding to
rounding) and over max |rhof|; each version against the node form summed
in float64, over the charge scale (the kernel's worst of ERR_CALLS calls:
its atomics add in an order that changes from call to call); the lanes
that took the kernel's global path; its launches a call; its time (device
ms from torch.profiler and CUDA-event ms) and the plain version's; and its
bound: 1 byte a slot (the live mark), 20 a live lane (dx, dy, dz, the
voxel, the weight) and rhof read and written once, over 3.35 TB/s.
Prints one JSON line; ``main()`` returns it as a dict.  Needs a CUDA card.
"""

from __future__ import annotations

import json

import torch

from . import cuda_ms, device_ms, kernel_device_ms

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
STEPS = 3                       # graphed steps before the deposit
KERNEL_CALLS = 20               # calls a timing window
PLAIN_CALLS = 3
ERR_CALLS = 10                  # kernel calls whose worst error is read
# the decks, at the benchmark cells' sizes
DECKS = dict(harris3d=dict(nx=32, ny=32, nz=32, nppc=128, Lx=16.0, Ly=16.0,
                           Lz=16.0),
             sc08=dict(nx=150, ny=25, nz=100, nppc=1),
             harris2d=dict(nx=64, ny=64, nppc=64))


def build(name: str, dev, **params):
    """The deck ``name`` of DECKS on ``dev`` with ``params``."""
    from ..models import harris, sc08
    if name == "sc08":
        return sc08.build(sc08.SC08Params(**params), device=dev)
    return harris.build(harris.HarrisParams(**params), device=dev)


def deck_state(name: str, dev, params: dict):
    """(sim, state, home maps or None, the run) after STEPS steps of the
    deck; the run is {"path", "cleaning_steps", "launches"}: the step's
    path, its cleaning steps and the kernel's launches in initialize() and
    the steps (after step_graph.settle())."""
    from .. import step_graph as SG
    from ..ops import rho_p as RHO
    sim = build(name, dev, **params)
    n0 = RHO.launches
    state = sim.initialize()
    step = sim.make_step()
    cadence = getattr(step, "advance", step).cadence
    cleans = 0
    for _ in range(STEPS):
        cleans += cadence(state.step, state.diag).clean_e
        state = step(state)
    SG.settle()
    homes = None
    if step.path == "push3d":
        homes = [state.diag[f"_chart_home{k}"]
                 for k in range(len(state.species))]
    run = dict(path=step.path, cleaning_steps=cleans,
               launches=RHO.launches - n0)
    return sim, state, homes, run


def bytes_moved(species, g) -> int:
    """The deposit's bytes: 1 a slot, 20 a live lane, rhof twice."""
    live = sum(int(sp.live.sum()) for sp in species)
    slots = sum(sp.capacity for sp in species)
    return slots + 20 * live + 8 * g.nv


def charge_scale(sp, q, g) -> float:
    """The largest node charge of one species alone (the plain deposit):
    the scale of rhof's rounding, where the net charge of a load in pairs
    is zero but for it (benchmark/check.py's floor of ``rho_err`` is one
    species' charge density for that reason)."""
    from ..ops.push import accumulate_rho_p
    one = torch.zeros(g.nv, dtype=torch.float32, device=sp.dx.device)
    return float(accumulate_rho_p(one, sp, g, q).abs().max())


def exact(species, qs, g) -> torch.Tensor:
    """The node form in float64: each live lane's 8 weights
    q (1 +- dx)(1 +- dy)(1 +- dz), q = qsp r8V w from the lanes' float32
    values, summed in double; a node past the mesh on an axis dropped."""
    dev = species[0].dx.device
    rho = torch.zeros(g.nv, dtype=torch.float64, device=dev)
    for sp, qsp in zip(species, qs):
        live = sp.live
        q = float(torch.tensor(qsp * g.r8V, dtype=torch.float32)) \
            * sp.w[live].double()
        d = [getattr(sp, n)[live].double() for n in ("dx", "dy", "dz")]
        i = sp.i[live].long()
        z, r = i // g.sz, i % g.sz
        y, x = r // g.sy, r % g.sy
        for j in range(8):
            a, b, c = j & 1, (j >> 1) & 1, j >> 2
            wt = q * (1 + (2 * a - 1) * d[0]) * (1 + (2 * b - 1) * d[1]) \
                * (1 + (2 * c - 1) * d[2])
            keep = (x + a < g.NX) & (y + b < g.NY) & (z + c < g.NZ)
            rho.index_add_(0, (i + a + g.sy * b + g.sz * c)[keep], wt[keep])
    return rho


def errors(sim, species, homes) -> dict:
    """ERR_CALLS calls of the kernel (the wrapper) and one of the plain
    version on ``species``: the largest difference between them over the
    charge scale and over max |rhof|, the largest difference of each from
    ``exact`` over the charge scale, the last call's lane counts and the
    launches a call."""
    from ..ops import rho_p as RHO
    from ..ops.push import accumulate_rho_p
    g = sim.grid
    qs = [st.params.q for st in sim.species]
    dev = species[0].dx.device
    zero = lambda: torch.zeros(g.nv, dtype=torch.float32, device=dev)
    want = zero()
    for sp, q in zip(species, qs):
        accumulate_rho_p(want, sp, g, q)
    ref = exact(species, qs, g)
    net = float(want.abs().max())
    scale = max([net] + [charge_scale(sp, q, g) for sp, q in zip(species, qs)])
    diff = off = 0.0
    n0 = RHO.launches
    for _ in range(ERR_CALLS):
        RHO.deposits = None
        got = RHO.accumulate_rho_multi(zero(), species, qs, g, homes)
        diff = max(diff, float((got - want).abs().max()))
        off = max(off, float((got.double() - ref).abs().max()))
    glob, live = RHO.deposits.tolist()
    return dict(max_abs_err=diff / scale,
                err_of_max_rhof=diff / net if net else None,
                kernel_err_exact=off / scale,
                plain_err_exact=float((want.double() - ref).abs().max())
                / scale,
                global_lanes=glob, deposited_lanes=live,
                launches=(RHO.launches - n0) / ERR_CALLS)


def compare(sim, state, homes, run: dict) -> dict:
    """``errors`` on one state, and both versions timed."""
    from ..ops import rho_p as RHO
    from ..ops.push import accumulate_rho_p
    g = sim.grid
    species = list(state.species)
    qs = [st.params.q for st in sim.species]
    res = dict(run=run, tile=homes is not None,
               lanes=sum(int(sp.live.sum()) for sp in species),
               slots=sum(sp.capacity for sp in species),
               **errors(sim, species, homes))
    res["bound_ms"] = bytes_moved(species, g) / HBM_BYTES_PER_S * 1e3
    buf = torch.zeros(g.nv, dtype=torch.float32, device=species[0].dx.device)

    def kernel():
        RHO.accumulate_rho_multi(buf, species, qs, g, homes)

    def plain():
        for sp, q in zip(species, qs):
            accumulate_rho_p(buf, sp, g, q)

    res["device_ms"] = kernel_device_ms(kernel, "rho_p_kernel", KERNEL_CALLS)
    res["ms"] = cuda_ms(kernel, KERNEL_CALLS)
    res["plain_device_ms"] = device_ms(plain, PLAIN_CALLS)
    res["plain_ms"] = cuda_ms(plain, PLAIN_CALLS)
    res["bound_pct"] = (100.0 * res["bound_ms"] / res["device_ms"]
                        if res["device_ms"] else None)
    return res


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("rho_bench needs a CUDA device")
    dev = torch.device("cuda")
    out = {"kernel": "rho_p", "device": torch.cuda.get_device_name(dev)}
    for name, params in DECKS.items():
        sim, state, homes, run = deck_state(name, dev, params)
        out[name] = compare(sim, state, homes, run)
        del sim, state, homes
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
