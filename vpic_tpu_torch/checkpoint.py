"""Checkpoint / restart (counterpart of ``vpic_tpu/checkpoint.py``), in
the JAX package's file format, so that each package restores the other's
checkpoints.

``checkpt`` writes ``{fbase}.{tag}.npz`` with the keys ``f.<field>``,
``sp<k>.<name>``, ``step``, ``rng`` (the JAX package's uint32 state key)
and ``diag::<name>``, and ``{fbase}.{tag}.json`` with the deck's config;
the deck (Python) is re-run to rebuild the program and the saved arrays
replace the fresh state -- the analogue of --restore (deck/main.cc:74-91).
The ``diag::`` keys are exactly those ``vpic_tpu``'s initialize() makes
for the deck (``vpic_tpu.checkpoint.restore`` loads every one of them into
the carry of its jitted step), with the residency flag ``_res_valid`` as
int32.  What only the port keeps -- the Simulation's ``torch.Generator``
state and the unfinished-streak count -- goes under ``torch::`` keys,
which ``vpic_tpu`` does not read.

``modify`` implements --modify (misc.cc:136+): ASCII "field value" lines
overriding num_step and the dump/clean intervals on restore.  ``remap``
(a checkpoint onto another decomposition) waits for the decomposition
port.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from .grid import PERIODIC
from .interop import HOST_DIAG, _SPECIES_DTYPES
from .state import (FIELD_NAMES, SPECIES_NAMES, FieldState, SimState,
                    SpeciesState)

PORT = "torch::"
# diag entries the JAX package's step does not carry
PORT_DIAG = ("unfinished",)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def checkpt(state: SimState, fbase: str, tag=None, sim=None) -> str:
    """Write ``{fbase}.{tag}.npz`` (+ the .json config when ``sim`` is
    given), ``tag`` the step by default, like the reference's
    checkpt(fbase, tag) naming (deck/main.cc:47-54); returns
    ``{fbase}.{tag}``.  A state without a key (``rng`` None) gets
    PRNGKey(sim.seed), as [0, seed]."""
    tag = int(state.step) if tag is None else tag
    fname = f"{fbase}.{tag}"
    arrays = {}
    for n in FIELD_NAMES:
        arrays[f"f.{n}"] = _host(getattr(state.fields, n))
    for k, sp in enumerate(state.species):
        for n in SPECIES_NAMES:
            arrays[f"sp{k}.{n}"] = _host(getattr(sp, n))
    arrays["step"] = np.int32(state.step)
    rng = state.rng
    if rng is None:
        rng = [0, sim.seed if sim is not None else 0]
    arrays["rng"] = np.asarray(rng, np.uint32)
    for n, v in (state.diag or {}).items():
        if n in PORT_DIAG:
            arrays[f"{PORT}diag::{n}"] = _host(v)
        elif n in HOST_DIAG:
            arrays[f"diag::{n}"] = np.int32(v)
        else:
            arrays[f"diag::{n}"] = _host(v)
    gen = getattr(sim, "_generator", None)
    if gen is not None:
        arrays[f"{PORT}generator"] = gen.get_state().numpy()
        arrays[f"{PORT}generator_device"] = np.array(gen.device.type)
    np.savez_compressed(fname + ".npz", **arrays)

    if sim is not None:
        g = sim.grid
        cfg = dict(
            num_step=sim.num_step,
            status_interval=sim.status_interval,
            sync_shared_interval=sim.sync_shared_interval,
            clean_div_e_interval=sim.clean_div_e_interval,
            clean_div_b_interval=sim.clean_div_b_interval,
            num_comm_round=sim.num_comm_round,
            damp=sim.damp,
            species=[dict(name=st.params.name, q=st.params.q, m=st.params.m,
                          capacity=st.params.capacity)
                     for st in sim.species],
            grid=dict(nx=g.nx, ny=g.ny, nz=g.nz, dt=g.dt,
                      topology=list(g.topology),
                      field_bc=list(g.field_bc),
                      particle_bc=list(g.particle_bc),
                      face_partners=(
                          None if g.face_partners is None else
                          [list(t) for t in g.face_partners])),
            user_global=getattr(sim, "user_global", {}),
        )
        with open(fname + ".json", "w") as fh:
            json.dump(cfg, fh, indent=1)
    return fname


def canonical_voxels(i: np.ndarray, live: np.ndarray, n, periodic):
    """Live lanes' voxel indices moved to their canonical interior cells:
    the JAX package's 2-D fused path keeps lanes in periodic ghost cells
    and, with nz == 1 and y periodic, in unwrapped-y images in the z = 0 /
    z = 2 plane thirds (``vpic_tpu/ops/pallas_push.py``,
    remap_ghost_voxels).  ``n`` is (nx, ny, nz), ``periodic`` whether each
    axis' particle faces are periodic.  Canonical indices (the port's) come
    back unchanged; dead lanes keep theirs."""
    nx, ny, nz = n
    NX, NY = nx + 2, ny + 2
    i64 = i.astype(np.int64)
    zi, r = np.divmod(i64, NX * NY)
    yi, xi = np.divmod(r, NX)
    y_unwrapped = nz == 1 and periodic[1]
    if y_unwrapped:
        yu = yi + (zi - 1) * NY            # unwrapped y in [-NY, 2 NY)
        yi = (yu - 1) % ny + 1
        zi = np.ones_like(zi)
    coords = [xi, yi, zi]
    for ax, n_ax in enumerate(n):
        if not periodic[ax] or (ax == 1 and y_unwrapped):
            continue
        c = coords[ax]
        c = np.where(c == 0, n_ax, c)
        coords[ax] = np.where(c == n_ax + 1, 1, c)
    vox = coords[0] + NX * (coords[1] + NY * coords[2])
    return np.where(live, vox, i64).astype(np.int32)


def _check_config(cfg, g):
    gg = cfg["grid"]
    if (gg["nx"], gg["ny"], gg["nz"]) != (g.nx, g.ny, g.nz) or \
            tuple(gg["topology"]) != tuple(g.topology):
        raise ValueError(f"checkpoint grid/topology mismatch: {gg} vs {g}")
    fp_saved = gg.get("face_partners")
    fp_saved = (None if fp_saved is None else
                tuple(tuple(t) for t in fp_saved))
    if fp_saved != g.face_partners:
        raise ValueError(
            "checkpoint domain-graph (face_partners) mismatch: saved "
            f"{fp_saved} vs deck {g.face_partners}")


def restore(fbase_tag: str, sim=None, device=None) -> SimState:
    """Rebuild a SimState from ``{fbase}.{tag}``, written by either
    package, on ``sim.device`` (or ``device``: the card unless the caller
    asks for the CPU).

    With ``sim``: its grid is checked against the saved config, its
    num_step and user_global are taken from it, the diag gets every entry
    the deck's initialize() makes (a checkpoint without the residency
    keys, as the JAX package's 2-D ones, restores with ``_res_valid``
    False, so the first step rebuckets) and the Simulation's generator
    gets the saved state; a checkpoint written by ``vpic_tpu`` (which has
    none) reseeds it from the deck's seed, as initialize() does.  Live
    lanes' voxels are made canonical (``canonical_voxels``): a JAX
    fused-path checkpoint holds ghost and unwrapped-y encodings; if that
    moved a lane of a residency state, the first step rebuckets."""
    data = np.load(fbase_tag + ".npz")
    cfg_path = fbase_tag + ".json"
    cfg = None
    if os.path.exists(cfg_path):
        with open(cfg_path) as fh:
            cfg = json.load(fh)
    if sim is not None:
        dev = sim.device
        if cfg is not None:
            _check_config(cfg, sim.grid)
            sim.num_step = cfg["num_step"]
            sim.user_global = cfg.get("user_global", {})
    else:
        dev = torch.device(device or "cuda")

    t = lambda a: torch.from_numpy(np.array(a, order="C")).to(dev)
    fields = FieldState(**{n: t(data[f"f.{n}"].astype(np.float32, copy=False))
                           for n in FIELD_NAMES})
    if sim is not None:
        g = sim.grid
        grid_n = (g.nx, g.ny, g.nz)
        periodic = tuple(g.axis_bc(ax, -1, particles=True) == PERIODIC
                         for ax in range(3))
    elif cfg is not None:
        gg = cfg["grid"]
        grid_n = (gg["nx"], gg["ny"], gg["nz"])
        periodic = tuple(gg["particle_bc"][ax] == PERIODIC
                         for ax in range(3))
    else:
        grid_n = None
    species, moved = [], False
    k = 0
    while f"sp{k}.dx" in data:
        cols = {n: np.asarray(data[f"sp{k}.{n}"], _SPECIES_DTYPES[n])
                for n in SPECIES_NAMES}
        if grid_n is not None:
            i = canonical_voxels(cols["i"], cols["live"], grid_n, periodic)
            moved |= bool((i != cols["i"]).any())
            cols["i"] = i
        species.append(SpeciesState(**{n: t(v) for n, v in cols.items()}))
        k += 1

    saved = {n[len("diag::"):]: data[n] for n in data.files
             if n.startswith("diag::")}
    saved.update({n[len(PORT + "diag::"):]: data[n] for n in data.files
                  if n.startswith(PORT + "diag::")})
    diag = sim._initial_diag() if sim is not None else {}
    for n, v in saved.items():
        ref = diag.get(n)
        if isinstance(ref, torch.Tensor) and tuple(ref.shape) != v.shape:
            continue                      # another deck's layout: keep ours
        diag[n] = HOST_DIAG[n](v) if n in HOST_DIAG else t(v)
    if "_res_valid" in diag:
        homes = [n for n in diag if n.startswith("_chart_home")]
        if moved or not all(n in saved and tuple(diag[n].shape)
                            == saved[n].shape for n in homes):
            diag["_res_valid"] = False

    if sim is not None:
        gen = torch.Generator(device=sim.device)
        key = f"{PORT}generator"
        if key in data.files and str(data[f"{PORT}generator_device"]) \
                == sim.device.type:
            gen.set_state(torch.from_numpy(np.array(data[key])))
        else:
            gen.manual_seed(sim.seed)
        sim._generator = gen
    return SimState(fields=fields, species=tuple(species),
                    step=int(np.asarray(data["step"]).max()), diag=diag,
                    rng=np.array(data["rng"], np.uint32))


def modify(sim, path: str):
    """--modify (misc.cc:136+): ASCII 'field value' per line."""
    allowed = {"num_step", "status_interval", "sync_shared_interval",
               "clean_div_e_interval", "clean_div_b_interval",
               "num_comm_round"}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) != 2:
                continue
            field, val = parts
            if field in allowed:
                setattr(sim, field, int(float(val)))
    return sim


def checksum(state: SimState) -> str:
    """Field/species state checksum (the optional OpenSSL checksum hooks,
    src/vpic/misc.cc:177-280) for regression comparisons; the JAX
    package's checksum of the same state."""
    h = hashlib.sha256()
    for n in FIELD_NAMES:
        h.update(_host(getattr(state.fields, n)).tobytes())
    for sp in state.species:
        for n in SPECIES_NAMES:
            h.update(_host(getattr(sp, n)).tobytes())
    return h.hexdigest()
