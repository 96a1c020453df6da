"""The plain reference of the SC08 one-triblade demo deck: its derived
parameters, its particle load from the seed and its initial state, worked
out from the configuration file alone.

VPIC ``sample/SC08_ONE_TRIBLADE_DEMO``, LANL's demo on one Roadrunner
triblade: a 3-D Harris current sheet in x, B = b0 tanh(x/L) rotated by
theta about x, pec field walls and reflecting particle walls at +-x,
periodic y and z, and two populations a species, a drifting sheet and a
Maxwellian background at density nb_n0 n0, each with its own macro
weight.  Electrons are the first species, ions the second.  The box keeps
the demo's cells per d_i: Lx = 30 d_i nx / 150, Ly = 5 d_i ny / 25 (written
30 d_i / 6), Lz = 20 d_i nz / 100.  "nppc" particles a cell is read as Ne
= nppc nx ny nz pairs, split between sheet and background by their
physical counts (each count rounded down).

The load draws from one ``numpy.random.default_rng(seed)``, pair by pair:
for each sheet pair x by rejection from L atanh(U(-1, 1) tanh(Lx / 2L)),
then y, z, the electron's three normals and the ion's three normals,
each boosted by its drift and rotated by theta; then for each background
pair x, y, z, the electron's normals and the ion's normals.  The step is
``pic.step``: the deck draws nothing once loaded.

Departures from the demo: one domain (the demo ran four ranks of one
triblade, (1, 1, 4)), so no halo exchange between ranks; the cleaners
and the shared-face syncs every 20 steps, as the deck's
``clean_div_e_interval``, ``clean_div_b_interval`` and
``sync_shared_interval`` set them; no field damping (``damp`` 0)."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import harris, pic

KEYS = ("mi_me", "rhoi_L", "Ti_Te", "Tb_Te", "nb_n0", "wpe_wce", "theta",
        "nx", "ny", "nz", "nppc", "cfl_req", "wpedt_max", "damp")
# the deck's cleaning and shared-face sync cadence, in steps
CLEAN_INTERVAL = 20


def derive(p: dict) -> dict:
    """The deck's derived quantities (the demo's units section)."""
    missing = [k for k in KEYS if k not in p]
    if missing:
        raise KeyError(f"the sc08 configuration lacks {missing}")
    c, ec, me, eps0, L = 1.0, 1.0, 1.0, 1.0, 1.0
    mi = me * p["mi_me"]
    Te = me * c * c / (2 * eps0 * p["wpe_wce"] ** 2 * (1 + p["Ti_Te"]))
    Ti = Te * p["Ti_Te"]
    Tb = Te * p["Tb_Te"]
    vthi = math.sqrt(Ti / mi)
    wci = vthi / (p["rhoi_L"] * L)
    wce = wci * p["mi_me"]
    wpe = wce * p["wpe_wce"]
    wpi = wpe / math.sqrt(p["mi_me"])
    di = c / wpi
    nx, ny, nz = int(p["nx"]), int(p["ny"]), int(p["nz"])
    Lx = 30 * di * nx / 150.0
    Ly = 30 * di / 6.0 * ny / 25.0
    Lz = 20 * di * nz / 100.0
    b0 = me * c * wce / ec
    n0 = me * eps0 * wpe * wpe / (ec * ec)
    vdre = b0 / (L * ec * n0 * (1 + p["Ti_Te"]))
    vdri = -p["Ti_Te"] * vdre
    tanhf = math.tanh(0.5 * Lx / L)
    sheet = 2 * n0 * Ly * Lz * L * tanhf
    back = p["nb_n0"] * n0 * Ly * Lz * Lx
    Ne = p["nppc"] * nx * ny * nz
    n_sheet = int(Ne * sheet / (sheet + back))
    n_back = int(Ne * back / (sheet + back))
    s = sum((1.0 / (Ln / n)) ** 2 for Ln, n in ((Lx, nx), (Ly, ny), (Lz, nz))
            if n > 1)
    dt = p["cfl_req"] * s ** -0.5 / c
    if wpe * dt > p["wpedt_max"]:
        dt = p["wpedt_max"] / wpe
    gdre = 1 / math.sqrt(1 - vdre * vdre)
    gdri = 1 / math.sqrt(1 - vdri * vdri)
    return dict(
        L=L, c=c, eps0=eps0, ec=ec, me=me, mi=mi, b0=b0, n0=n0, dt=dt,
        Lx=Lx, Ly=Ly, Lz=Lz, tanhf=tanhf,
        cs=math.cos(p["theta"]), sn=math.sin(p["theta"]),
        n_sheet=n_sheet, n_back=n_back,
        w_sheet=sheet / max(n_sheet, 1), w_back=back / max(n_back, 1),
        udre=vdre * gdre, udri=vdri * gdri, gdre=gdre, gdri=gdri,
        uthe=math.sqrt(Te / me) / c, uthi=math.sqrt(Ti / mi) / c,
        utheb=math.sqrt(Tb / me) / c, uthib=math.sqrt(Tb / mi) / c)


def geom(p: dict) -> pic.Geom:
    d = derive(p)
    nx, ny, nz = int(p["nx"]), int(p["ny"]), int(p["nz"])
    return pic.Geom(
        nx=nx, ny=ny, nz=nz, dx=d["Lx"] / nx, dy=d["Ly"] / ny,
        dz=d["Lz"] / nz, dt=d["dt"], cvac=d["c"], eps0=d["eps0"],
        field_bc=(pic.PEC, pic.PERIODIC, pic.PERIODIC) * 2,
        particle_bc=(pic.REFLECT, pic.P_PERIODIC, pic.P_PERIODIC) * 2,
        damp=p["damp"], clean_interval=CLEAN_INTERVAL)


def field_scales(p: dict) -> dict:
    """The deck's own field amplitudes, the floors of the compared field
    errors' scales: the sheet's field b0 (E and cB), the sheet's current
    b0 c eps0 / L and the density of one species' charge n0 e (the net
    charge starts at zero: electrons and ions are loaded in pairs)."""
    d = derive(p)
    b = d["b0"] * d["c"]
    return {"e_err": b, "b_err": b, "jf_err": b * d["eps0"] / d["L"],
            "rho_err": d["n0"] * d["ec"]}


def draws(p: dict, seed: int):
    """The load's draws in the deck's order: (x, y, z, electron normals,
    ion normals), each pair's row, the sheet pairs first."""
    d = derive(p)
    rng = np.random.default_rng(seed)
    Lx, Ly, Lz, L, tanhf = d["Lx"], d["Ly"], d["Lz"], d["L"], d["tanhf"]
    n = d["n_sheet"] + d["n_back"]
    pos = np.empty((n, 3))
    ue = np.empty((n, 3))
    ui = np.empty((n, 3))
    for k in range(d["n_sheet"]):
        while True:
            x = L * math.atanh(rng.uniform(-1, 1) * tanhf)
            if -0.5 * Lx < x < 0.5 * Lx:
                break
        pos[k] = x, rng.uniform(0, Ly), rng.uniform(0, Lz)
        ue[k] = rng.normal(0, d["uthe"], 3)
        ui[k] = rng.normal(0, d["uthi"], 3)
    for k in range(d["n_sheet"], n):
        pos[k] = (rng.uniform(-0.5 * Lx, 0.5 * Lx), rng.uniform(0, Ly),
                  rng.uniform(0, Lz))
        ue[k] = rng.normal(0, d["utheb"], 3)
        ui[k] = rng.normal(0, d["uthib"], 3)
    return pos, ue, ui


def _boosted(u: np.ndarray, ud: float, gd: float, cs: float, sn: float):
    """A sheet population's momenta: the drift ud along y (gd its gamma),
    then the rotation by theta about x."""
    ux, uy, uz = u[:, 0], u[:, 1], u[:, 2]
    d0 = gd * uy + np.sqrt(ux * ux + uy * uy + uz * uz + 1) * ud
    return np.stack([ux, d0 * cs - uz * sn, d0 * sn + uz * cs], axis=1)


def load(p: dict, seed: int, device, dtype=torch.float32):
    """The deck's fields and lanes before initialize(): (fields, species)
    in the reference's plain form."""
    d = derive(p)
    g = geom(p)
    L, b0, c, cs, sn = d["L"], d["b0"], d["c"], d["cs"], d["sn"]

    f = pic.zero_fields(g, dtype, device)
    # B on its Yee stagger over the ghosts too, each value as the deck's
    # expression gives it at its x centre: neither depends on y or z
    xc = (-0.5 * d["Lx"] + g.dx * (np.arange(g.NX) - 1.0)) + 0.5 * g.dx
    for name, amp in (("cby", -sn), ("cbz", cs)):
        val = np.vectorize(lambda x: amp * b0 * np.tanh(x / L),
                           otypes=[np.float64])(xc)
        row = (c * val).astype(np.float32)
        f[name][:] = torch.from_numpy(row).to(device=device, dtype=dtype)

    pos, ue, ui = draws(p, seed)
    ns = d["n_sheet"]
    ue[:ns] = _boosted(ue[:ns], d["udre"], d["gdre"], cs, sn)
    ui[:ns] = _boosted(ui[:ns], d["udri"], d["gdri"], cs, sn)
    w = np.concatenate([np.full(ns, d["w_sheet"]),
                        np.full(d["n_back"], d["w_back"])])

    ox, ix = harris._cell(pos[:, 0], -0.5 * d["Lx"], 0.5 * d["Lx"], g.nx)
    oy, iy = harris._cell(pos[:, 1], 0.0, d["Ly"], g.ny)
    oz, iz = harris._cell(pos[:, 2], 0.0, d["Lz"], g.nz)
    vox = (ix + g.NX * (iy + g.NY * iz)).astype(np.int32)

    def t(a, kind=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)
                                if kind is not torch.int32 else a).to(
            device=device, dtype=kind)

    species = []
    for q, m, u in ((-d["ec"], d["me"], ue), (d["ec"], d["mi"], ui)):
        species.append(dict(
            dx=t(ox), dy=t(oy), dz=t(oz), i=t(vox, torch.int32),
            ux=t(u[:, 0]), uy=t(u[:, 1]), uz=t(u[:, 2]), w=t(w), q=q, m=m))
    return f, species


def initial_state(p: dict, seed: int, device):
    """The state initialize() makes for the deck: (fields, species)."""
    f, species = load(p, seed, device)
    return pic.initialize(f, species, geom(p))
