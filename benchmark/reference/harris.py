"""The plain reference of the harris deck: its derived parameters, its
particle load from the seed and its initial state, worked out from the
configuration file alone.

VPIC ``sample/harris`` (Daughton, Phys. Plasmas 9, 3668 (2002)): a current
sheet B = b0 tanh(x/L) z (rotated by theta about x) carried by drifting
Maxwellian ions and electrons, periodic in y and z, pec field walls and
reflecting particle walls at +-x.  The load draws, from one
``numpy.random.RandomState(seed)``, the x of each ion-electron pair by
rejection from L atanh(U(-1, 1)), then y, z, the ions' three normals and
the electrons' three normals, each as one vector draw, in that order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import pic

KEYS = ("mass_ratio", "rhoi_L", "Ti_Te", "wpe_wce", "theta", "taui", "Lx",
        "Ly", "Lz", "nx", "ny", "nz", "nppc", "cfl_req", "wpedt_max", "damp")


def derive(p: dict) -> dict:
    """The deck's derived quantities (sample/harris's units section)."""
    missing = [k for k in KEYS if k not in p]
    if missing:
        raise KeyError(f"the harris configuration lacks {missing}")
    L = 1.0
    ec, me, c, eps0 = 1.0, 1.0, 1.0, 1.0
    mi = me * p["mass_ratio"]
    kTe = me * c * c / (2 * p["wpe_wce"] ** 2 * (1 + p["Ti_Te"]))
    kTi = kTe * p["Ti_Te"]
    vthi = math.sqrt(2 * kTi / mi)
    wci = vthi / (p["rhoi_L"] * L)
    wce = wci * p["mass_ratio"]
    wpe = wce * p["wpe_wce"]
    vdre = c * c * wce / (wpe * wpe * L * (1 + p["Ti_Te"]))
    vdri = -p["Ti_Te"] * vdre
    b0 = me * wce / ec
    n0 = me * eps0 * wpe * wpe / (ec * ec)
    Lx, Ly, Lz = p["Lx"], p["Ly"], p["Lz"]
    nx, ny, nz = int(p["nx"]), int(p["ny"]), int(p["nz"])
    Npe = 2 * n0 * Ly * Lz * L * math.tanh(0.5 * Lx / L)
    Ne = 0.5 * p["nppc"] * nx * ny * nz
    dg = sum((n / Ln) ** 2 for Ln, n in ((Lx, nx), (Ly, ny), (Lz, nz))
             if n > 1) ** -0.5
    dt = p["cfl_req"] * dg / c
    if wpe * dt > p["wpedt_max"]:
        dt = p["wpedt_max"] / wpe
    gdri = 1 / math.sqrt(1 - vdri * vdri / (c * c))
    gdre = 1 / math.sqrt(1 - vdre * vdre / (c * c))
    return dict(
        L=L, c=c, eps0=eps0, mi=mi, me=me, b0=b0, n0=n0, ec=ec, dt=dt,
        wci=wci,
        num_step=int(0.2 * p["taui"] / (wci * dt)),
        status=max(1, int(1.0 / (wci * dt))),
        n_pairs=int(Ne), weight=Npe / Ne,
        uthi=math.sqrt(kTi / mi) / c, uthe=math.sqrt(kTe / me) / c,
        udri=vdri * gdri, udre=vdre * gdre, gdri=gdri, gdre=gdre)


def geom(p: dict) -> pic.Geom:
    d = derive(p)
    nx, ny, nz = int(p["nx"]), int(p["ny"]), int(p["nz"])
    return pic.Geom(
        nx=nx, ny=ny, nz=nz, dx=p["Lx"] / nx, dy=p["Ly"] / ny,
        dz=p["Lz"] / nz, dt=d["dt"], cvac=d["c"], eps0=d["eps0"],
        field_bc=(pic.PEC, pic.PERIODIC, pic.PERIODIC) * 2,
        particle_bc=(pic.REFLECT, pic.P_PERIODIC, pic.P_PERIODIC) * 2,
        damp=p["damp"], clean_interval=d["status"])


def field_scales(p: dict) -> dict:
    """The deck's own field amplitudes, the floors of the compared field
    errors' scales: the sheet's field b0 (E and cB), the sheet's current
    b0 c eps0 / L and the density of one species' charge n0 e (the net
    charge starts at zero: ions and electrons are loaded in pairs)."""
    d = derive(p)
    b = d["b0"] * d["c"]
    return {"e_err": b, "b_err": b, "jf_err": b * d["eps0"] / d["L"],
            "rho_err": d["n0"] * d["ec"]}


def _cell(v: np.ndarray, lo: float, hi: float, n: int):
    """Global coordinates -> (offset in [-1, 1], 1-based cell), in double
    precision (VPIC's misc.cc:16-100)."""
    v = float(n) * ((v - lo) / (hi - lo))
    iv = np.floor(v).astype(np.int64)
    off = (v - iv) * 2.0 - 1.0
    top = iv == n
    return np.where(top, 1.0, off), np.where(top, n - 1, iv) + 1


def load(p: dict, seed: int, device, dtype=torch.float32):
    """The deck's fields and lanes before initialize(): (fields, species)
    in the reference's plain form."""
    d = derive(p)
    g = geom(p)
    L, b0, c = d["L"], d["b0"], d["c"]
    cs, sn = math.cos(p["theta"]), math.sin(p["theta"])
    Lx, Ly, Lz = p["Lx"], p["Ly"], p["Lz"]

    f = pic.zero_fields(g, dtype, device)
    # B on its Yee stagger over the ghosts too: cby at (x centre, y node,
    # z centre), cbz at (x centre, y centre, z node); neither depends on y
    # or z
    xc = (-0.5 * Lx + g.dx * (np.arange(g.NX) - 1.0)) + 0.5 * g.dx
    prof = np.tanh(xc / L)
    for name, amp in (("cby", -sn * b0), ("cbz", cs * b0)):
        row = (c * (amp * prof)).astype(np.float32)
        f[name][:] = torch.from_numpy(row).to(device=device, dtype=dtype)

    rng = np.random.RandomState(seed)
    n = d["n_pairs"]
    xs = np.empty(0)
    while xs.size < n:
        cand = L * np.arctanh(rng.uniform(-1, 1, 2 * n))
        cand = cand[(cand > -0.5 * Lx) & (cand < 0.5 * Lx)]
        xs = np.concatenate([xs, cand])[:n]
    ys = rng.uniform(0, Ly, n)
    zs = rng.uniform(0, Lz, n)

    def boosted(uth, ud, gd):
        ux = rng.normal(0, uth, n)
        uy = rng.normal(0, uth, n)
        uz = rng.normal(0, uth, n)
        d0 = gd * uy + np.sqrt(ux * ux + uy * uy + uz * uz + 1) * ud
        return ux, d0 * cs - uz * sn, d0 * sn + uz * cs

    ox, ix = _cell(xs, -0.5 * Lx, 0.5 * Lx, g.nx)
    oy, iy = _cell(ys, 0.0, Ly, g.ny)
    oz, iz = _cell(zs, 0.0, Lz, g.nz)
    vox = (ix + g.NX * (iy + g.NY * iz)).astype(np.int32)

    def t(a, kind=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)
                                if kind is not torch.int32 else a).to(
            device=device, dtype=kind)

    species = []
    for q, m, u in ((1.0, d["mi"], boosted(d["uthi"], d["udri"], d["gdri"])),
                    (-1.0, d["me"], boosted(d["uthe"], d["udre"],
                                            d["gdre"]))):
        species.append(dict(
            dx=t(ox), dy=t(oy), dz=t(oz), i=t(vox, torch.int32),
            ux=t(u[0]), uy=t(u[1]), uz=t(u[2]),
            w=torch.full((n,), d["weight"], dtype=dtype, device=device),
            q=q, m=m))
    return f, species


def initial_state(p: dict, seed: int, device):
    """The state initialize() makes for the deck: (fields, species)."""
    f, species = load(p, seed, device)
    return pic.initialize(f, species, geom(p))
