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

On a decomposed grid every rank calls ``checkpt``: each array is gathered
to rank 0, which writes one file whose arrays carry the leading topology
dims ``(px, py, pz)`` -- the JAX package's sharded layout (its step,
key and diag entries included), so either package restores the other's
decomposed checkpoints -- and ``restore`` has rank 0 read the file and
scatter each rank its brick.  ``remap`` (restart_remap, vpic_tpu/
checkpoint.py:114-300) rebuilds a checkpoint written under any cartesian
topology for the deck's: fields are stitched into the global mesh and
split again, lanes re-binned by their global cell.

``modify`` implements --modify (misc.cc:136+): ASCII "field value" lines
overriding num_step and the dump/clean intervals on restore.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from .grid import PERIODIC
from .interop import HOST_DIAG, _SPECIES_DTYPES
from .parallel.mesh import mesh_of
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
    m = mesh_of(sim.grid) if sim is not None else None
    if m is not None:
        arrays = {k: _gather(m, sim.grid, v) for k, v in arrays.items()}
        if m.rank != 0:
            m.barrier()
            return fname
    if gen is not None:
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
    if m is not None:
        m.barrier()
    return fname


def _gather(m, g, a: np.ndarray) -> np.ndarray:
    """Every rank's ``a`` stacked under the leading topology dims, on rank
    0 (None elsewhere); it travels as bytes (Gloo moves no bool or uint32
    tensors)."""
    a = np.asarray(a, order="C")
    parts = m.gather_to_root(torch.from_numpy(a.reshape(-1).view(np.uint8)))
    if parts is None:
        return None
    return np.stack([p.numpy().view(a.dtype).reshape(a.shape)
                     for p in parts]).reshape(tuple(g.topology) + a.shape)


def _scatter(m, g, data):
    """Rank 0's decomposed checkpoint arrays (leading topology dims), each
    rank's brick of them: the key list and per-rank shapes go first."""
    n = g.n_shards
    meta = None
    if m.rank == 0:
        meta = [(k, v.shape[3:], v.dtype.str) for k, v in data.items()
                if v.dtype.kind != "U" and v.shape[:3] == tuple(g.topology)]
    meta = m.broadcast_object(meta)
    out = {}
    for k, shape, dt in meta:
        dt = np.dtype(dt)
        like = torch.zeros(int(np.prod(shape, dtype=np.int64)) * dt.itemsize,
                           dtype=torch.uint8)
        parts = None
        if m.rank == 0:
            flat = np.ascontiguousarray(data[k]).reshape((n, -1))
            parts = [torch.from_numpy(flat[r].view(np.uint8))
                     for r in range(n)]
        got = m.scatter_from_root(parts, like).cpu().numpy()
        out[k] = got.view(dt).reshape(shape)
    return out


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
    cfg_path = fbase_tag + ".json"
    cfg = None
    m = mesh_of(sim.grid) if sim is not None else None
    if m is None or m.rank == 0:
        data = dict(np.load(fbase_tag + ".npz"))
        if os.path.exists(cfg_path):
            with open(cfg_path) as fh:
                cfg = json.load(fh)
    if m is not None:
        cfg = m.broadcast_object(cfg)
    if sim is not None and cfg is not None:
        _check_config(cfg, sim.grid)
    if m is not None:
        data = _scatter(m, sim.grid, data if m.rank == 0 else None)
    return _state(data, cfg, sim, device)


def _state(data: dict, cfg, sim=None, device=None) -> SimState:
    """The SimState of one rank's checkpoint arrays (see restore)."""
    if sim is not None:
        dev = sim.device
        if cfg is not None:
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

    saved = {n[len("diag::"):]: data[n] for n in data
             if n.startswith("diag::")}
    saved.update({n[len(PORT + "diag::"):]: data[n] for n in data
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
        saved_dev = data.get(f"{PORT}generator_device", sim.device.type)
        if key in data and str(saved_dev) == sim.device.type:
            gen.set_state(torch.from_numpy(np.array(data[key])))
        else:
            gen.manual_seed(sim._generator_seed())
        sim._generator = gen
    return SimState(fields=fields, species=tuple(species),
                    step=int(np.asarray(data["step"]).max()), diag=diag,
                    rng=np.array(data["rng"], np.uint32))


def remap(fbase_tag: str, sim) -> SimState:
    """restart_remap (vpic_tpu/checkpoint.py:114-300): restore
    ``{fbase}.{tag}``, written under any cartesian topology, onto
    ``sim``'s.  The global grid must match; the capacities are the new
    deck's.  Fields are stitched into the ghost-extended global mesh (the
    owners' interiors win) and split again; live lanes are re-binned by
    their global cell; the key is rank 0's; diag tallies keep their global
    sums on rank 0 (ring buffers and home maps start anew); the
    generators are reseeded.  On a decomposed ``sim`` every rank calls it:
    rank 0 reads and re-splits, then scatters each rank its brick."""
    g = sim.grid
    m = mesh_of(g)
    data = None
    if m is None or m.rank == 0:
        data = _remap_arrays(dict(np.load(fbase_tag + ".npz")),
                             json.load(open(fbase_tag + ".json")), sim)
    if m is not None:
        data = _scatter(m, g, data)
    return _state(data, None, sim)


def _remap_arrays(data: dict, cfg: dict, sim) -> dict:
    """A checkpoint's arrays in the layout of a checkpoint of ``sim``'s
    topology (leading (px, py, pz) dims when it is decomposed)."""
    gg = cfg["grid"]
    told = tuple(gg["topology"])
    g = sim.grid
    tnew = tuple(g.topology)
    if g.face_partners is not None or gg.get("face_partners") is not None:
        raise NotImplementedError(
            "remap across topologies is cartesian-only; restore joined "
            "(face_partners) decks onto the same topology with restore()")
    nxo, nyo, nzo = gg["nx"], gg["ny"], gg["nz"]
    if (nxo * told[0], nyo * told[1], nzo * told[2]) != (g.gnx, g.gny,
                                                         g.gnz):
        raise ValueError("remap: global grid mismatch")
    sh_old, sh_new = told != (1, 1, 1), g.sharded
    NXo, NYo = nxo + 2, nyo + 2
    out = {}

    def stitch(A):
        """The ghost-extended global mesh: each global node from its one
        owner (interior indices 1..n of a brick, plus its ghost or
        boundary plane where the brick is first or last on the axis).
        vpic_tpu's remap writes whole bricks and then every owner's
        1..n interior, which leaves a brick's neighbour's ghost in a
        boundary plane of a third axis (plane n + 1 of an axis with one
        brick); this does not."""
        if not sh_old:
            return np.asarray(A)
        G = np.zeros((g.gnz + 2, g.gny + 2, g.gnx + 2), A.dtype)
        px, py, pz = told

        def own(s, n_s, n):
            lo = 0 if s == 0 else 1
            hi = n + 2 if s == n_s - 1 else n + 1
            return slice(s * n + lo, s * n + hi), slice(lo, hi)

        for sx in range(px):
            for sy in range(py):
                for sz in range(pz):
                    (gz, lz), (gy, ly), (gx, lx) = (
                        own(sz, pz, nzo), own(sy, py, nyo), own(sx, px, nxo))
                    G[gz, gy, gx] = A[sx, sy, sz][lz, ly, lx]
        return G

    def split(G):
        if not sh_new:
            return G
        res = np.zeros(tnew + g.shape, G.dtype)
        for sx in range(tnew[0]):
            for sy in range(tnew[1]):
                for sz in range(tnew[2]):
                    res[sx, sy, sz] = G[sz * g.nz:sz * g.nz + g.NZ,
                                        sy * g.ny:sy * g.ny + g.NY,
                                        sx * g.nx:sx * g.nx + g.NX]
        return res

    for n in FIELD_NAMES:
        out[f"f.{n}"] = split(stitch(data[f"f.{n}"]))

    k = 0
    while f"sp{k}.dx" in data:
        cols = {n: np.asarray(data[f"sp{k}.{n}"]) for n in SPECIES_NAMES}
        live = cols["live"].reshape(-1).astype(bool)
        flat = {n: cols[n].reshape(-1)[live] for n in SPECIES_NAMES
                if n != "np"}
        if sh_old:
            Nl = cols["dx"].shape[-1]
            sidx = np.indices(told)
            lane_shard = np.broadcast_to(
                sidx[..., None], (3,) + told + (Nl,)).reshape(3, -1)[:, live]
        else:
            lane_shard = np.zeros((3, int(live.sum())), np.int64)
        i = flat["i"].astype(np.int64)
        zi, r = np.divmod(i, NXo * NYo)
        yi, xi = np.divmod(r, NXo)
        if nzo == 1:        # the JAX fused path's unwrapped-y images
            yi = (yi + (zi - 1) * NYo - 1) % nyo + 1
            zi = np.ones_like(zi)
        gxi = (xi - 1) % nxo + 1 + lane_shard[0] * nxo
        gyi = (yi - 1) % nyo + 1 + lane_shard[1] * nyo
        gzi = (zi - 1) % nzo + 1 + lane_shard[2] * nzo
        ns = [np.clip((c - 1) // n, 0, t - 1) for c, n, t in
              zip((gxi, gyi, gzi), (g.nx, g.ny, g.nz), tnew)]
        new_i = ((gxi - ns[0] * g.nx) + g.NX * ((gyi - ns[1] * g.ny)
                 + g.NY * (gzi - ns[2] * g.nz))).astype(np.int32)
        cap = sim.species[k].params.capacity
        shp = (tnew + (cap,)) if sh_new else (cap,)
        res = {n: np.zeros(shp, cols[n].dtype) for n in SPECIES_NAMES
               if n != "np"}
        key = (ns[0] * tnew[1] + ns[1]) * tnew[2] + ns[2]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        counts = np.bincount(ks, minlength=int(np.prod(tnew)))
        if counts.max(initial=0) > cap:
            raise RuntimeError(
                f"remap: species {k}: a rank holds {int(counts.max())} > "
                f"capacity {cap}; raise max_local_np in the new deck")
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(ks.size) - start[ks]
        tgt = ((ns[0][order], ns[1][order], ns[2][order], slot) if sh_new
               else (slot,))
        for n in res:
            res[n][tgt] = (new_i[order] if n == "i" else True if n == "live"
                           else flat[n][order])
        res["np"] = (counts.reshape(tnew).astype(np.int32) if sh_new
                     else np.int32(counts.sum()))
        for n, v in res.items():
            out[f"sp{k}.{n}"] = v
        k += 1

    lead = tnew if sh_new else ()
    out["step"] = np.full(lead, int(np.asarray(data["step"]).max()),
                          np.int32)
    out["rng"] = np.broadcast_to(
        np.asarray(data["rng"], np.uint32).reshape(-1, 2)[0],
        lead + (2,)).copy()
    for n, v in data.items():
        if not n.startswith("diag::") or n.startswith("diag::_chart_home"):
            continue
        v = np.asarray(v)
        per = v.reshape((-1,) + v.shape[3:]) if sh_old else v[None]
        tot = per.sum(axis=0) if per.ndim <= 1 or per.shape[1:] == () \
            else np.zeros(per.shape[1:], v.dtype)
        res = np.zeros(lead + tot.shape, v.dtype)
        res[(0,) * len(lead)] = tot
        out[n] = res
    return out


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
