"""Diagnostic dumps (counterpart of ``vpic_tpu/dump.py``; src/vpic/dump.cc
+ dumpmacros.h).

Text dumps (energies, materials, species) and V0-format binary dumps
(fields, hydro, particles, grid) in the reference's layout
(WRITE_HEADER_V0, dumpmacros.h:7-41: binary-compat probe bytes, version,
dump type, step/grid metadata, rank/nproc, species id + q/m), so the
post-processors that read the reference's files (and
``utilities/read_dumps.py``) read these.  For the same state the files are
the JAX package's byte for byte, but for the floats computed here: hydro
moments (summed in another order) and the centred momenta of the particle
dump.  Each dump reads the state back from the device once, between
steps; the binary blocks go through the native writer (``native/io``).
On a decomposed grid every rank makes the call and writes its own file
``{fbase}.{tag}.{rank}`` (the hydro moments are synchronized across ranks
first), rank 0 writes the text files (energies, the strided dumps'
``.global`` stitch metadata), and every rank gets every file name back
once all are written (vpic_tpu/dump.py:86-346 writes the same files from
its global arrays).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from .deck import MAT_ID_ORDER
from .grid import Grid, flat_rank
from .native import io as native_io
from .ops import hydro as H
from .ops import interp as I
from .ops import push as P

DUMP_GRID = 0
DUMP_FIELDS = 1
DUMP_HYDRO = 2
DUMP_PARTICLES = 3

# the field_t member order of the 16 floats (field_advance.h:152-160)
FIELD_BANDS = ("ex", "ey", "ez", "div_e_err", "cbx", "cby", "cbz",
               "div_b_err", "tcax", "tcay", "tcaz", "rhob",
               "jfx", "jfy", "jfz", "rhof")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _rank(g: Grid) -> int:
    return flat_rank(g)


def _names(g: Grid, base: str):
    """Every rank's file name, ``{base}.{rank}``."""
    return [f"{base}.{r}" for r in range(g.n_shards)]


def _written(g: Grid, names):
    """Wait until every rank has written its file; returns ``names``."""
    from .parallel.mesh import mesh_of
    m = mesh_of(g)
    if m is not None:
        m.barrier()
    return names


def _header_v0(g: Grid, step: int, dump_type: int, sp_id: int = -1,
               q_m: float = 0.0, rank: int = 0) -> bytes:
    h = struct.pack("<5b", 8, 2, 4, 4, 8)
    h += struct.pack("<h", 0xcafe - 0x10000)   # 0xcafe as int16
    h += struct.pack("<i", -0x21524111)        # 0xdeadbeef as int32
    h += struct.pack("<f", 1.0) + struct.pack("<d", 1.0)
    h += struct.pack("<2i", 0, dump_type)
    h += struct.pack("<i", int(step))
    h += struct.pack("<3i", g.nx, g.ny, g.nz)
    h += struct.pack("<4f", g.dt, g.dx, g.dy, g.dz)
    h += struct.pack("<3f", g.x0, g.y0, g.z0)
    h += struct.pack("<3f", g.cvac, g.eps0, 0.0)
    h += struct.pack("<2i", rank, g.n_shards)
    h += struct.pack("<i", sp_id) + struct.pack("<f", q_m)
    return h


def _array_header(elem_size: int, dims) -> bytes:
    return struct.pack("<2i", elem_size, len(dims)) + \
        struct.pack(f"<{len(dims)}i", *dims)


def _species_index(sim, sp_name: str) -> int:
    return next(i for i, st in enumerate(sim.species)
                if st.params.name == sp_name)


def energies_line(step: int, en) -> str:
    """One data line of the energies file."""
    return f"{step} " + " ".join(f"{v:e}" for v in en) + "\n"


def dump_energies(sim, state, fname: str, append: bool = True):
    """dump_energies (dump.cc:37-77) text format: a header when not
    appending, then one line of step and the energies() columns (every
    rank sums the energies; rank 0 writes)."""
    en = _host(sim.energies(state))
    if _rank(sim.grid) != 0:
        return
    with open(fname, "a" if append else "w") as fh:
        if not append:
            names = " ".join(f'"{st.params.name}"' for st in sim.species)
            fh.write(f"%% Layout\n%% step ex ey ez bx by bz {names}\n")
            fh.write(f"%% timestep = {sim.grid.dt:e}\n")
        fh.write(energies_line(int(state.step), en))


def dump_materials(sim, fname: str):
    with open(fname, "w") as fh:
        fh.write("id name epsx epsy epsz mux muy muz "
                 "sigmax sigmay sigmaz zetax zetay zetaz\n")
        for m in sim.materials:
            fh.write(f"{m.id} {m.name} {m.epsx} {m.epsy} {m.epsz} "
                     f"{m.mux} {m.muy} {m.muz} {m.sigmax} {m.sigmay} "
                     f"{m.sigmaz} {m.zetax} {m.zetay} {m.zetaz}\n")


def dump_species(sim, fname: str):
    with open(fname, "w") as fh:
        fh.write("id name q m max_np sort_interval\n")
        for st in sim.species:
            p = st.params
            fh.write(f"{p.id} {p.name} {p.q} {p.m} {p.capacity} "
                     f"{p.sort_interval}\n")


def dump_fields(sim, state, fbase: str, ftag: Optional[int] = None):
    """field_dump (dump.cc:518+): V0 header + one interleaved field_t
    record per ghosted voxel: 16 floats + the 8 per-voxel material-id
    int16s (field_advance.h:152-160 member order) from the deck's
    stagger-class id meshes (zeros for a deck without
    set_region_material).  Returns the file names."""
    g = sim.grid
    rank = _rank(g)
    step = int(state.step)
    tag = step if ftag is None else ftag
    rec = np.zeros((g.nv,), dtype=[("f", "<f4", (16,)),
                                   ("m", "<i2", (8,))])  # field_t
    for ci, c in enumerate(FIELD_BANDS):
        rec["f"][:, ci] = _host(getattr(state.fields, c)).reshape(-1)
    mat_ids = getattr(sim, "_mat_ids", None)
    if mat_ids is not None:
        for mi, mc in enumerate(MAT_ID_ORDER):
            rec["m"][:, mi] = mat_ids[mc].reshape(-1)
    hdr = _header_v0(g, step, DUMP_FIELDS, rank=rank)
    hdr += _array_header(80, [g.NX, g.NY, g.NZ])
    names = _names(g, f"{fbase}.{tag}")
    native_io.write_file(names[rank], hdr + rec.tobytes())
    return _written(g, names)


def dump_hydro(sim, state, sp_name: str, fbase: str,
               ftag: Optional[int] = None):
    """hydro_dump (dump.cc): V0 header + 16-float hydro_t records (the 14
    moments, two zero pads).  Returns the file names."""
    g = sim.grid
    rank = _rank(g)
    step = int(state.step)
    tag = step if ftag is None else ftag
    k = _species_index(sim, sp_name)
    spp = sim.species[k].params
    rec = np.zeros((g.nv, 16), np.float32)
    rec[:, :H.N_HYDRO] = _host(H.compute_hydro(sim, state, k))
    hdr = _header_v0(g, step, DUMP_HYDRO, sp_id=spp.id, q_m=spp.q / spp.m,
                     rank=rank)
    hdr += _array_header(64, [g.NX, g.NY, g.NZ])
    names = _names(g, f"{fbase}.{tag}")
    native_io.write_file(names[rank], hdr + rec.astype("<f4").tobytes())
    return _written(g, names)


def dump_particles(sim, state, sp_name: str, fbase: str,
                   ftag: Optional[int] = None):
    """dump_particles (dump.cc:259-320): V0 header + 32-byte particle_t
    records of the live lanes, in slot order, with time-centered momenta
    (center_p before writing).  Returns the file names."""
    g = sim.grid
    rank = _rank(g)
    step = int(state.step)
    tag = step if ftag is None else ftag
    k = _species_index(sim, sp_name)
    spp = sim.species[k].params
    fcoef = I.load_interpolator(state.fields, g)
    lsp = P.center_p(state.species[k], fcoef, g, spp.q, spp.m)
    live = _host(lsp.live)
    n = int(live.sum())
    rec = np.zeros(n, dtype=[("dx", "<f4"), ("dy", "<f4"), ("dz", "<f4"),
                             ("i", "<i4"), ("ux", "<f4"), ("uy", "<f4"),
                             ("uz", "<f4"), ("w", "<f4")])
    for nme in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w"):
        rec[nme] = _host(getattr(lsp, nme))[live]
    hdr = _header_v0(g, step, DUMP_PARTICLES, sp_id=spp.id,
                     q_m=spp.q / spp.m, rank=rank)
    hdr += _array_header(32, [n])
    names = _names(g, f"{fbase}.{tag}")
    native_io.write_file(names[rank], hdr + rec.tobytes())
    return _written(g, names)


def dump_grid(sim, fbase: str):
    """dump_grid (dump.cc): the V0 header (the grid geometry), then the
    field and particle bcs and the topology.  Returns the file names."""
    g = sim.grid
    rank = _rank(g)
    hdr = _header_v0(g, 0, DUMP_GRID, rank=rank)
    body = struct.pack("<6i", *g.field_bc)
    body += struct.pack("<6i", *g.particle_bc)
    body += struct.pack("<3i", *g.topology)
    names = _names(g, fbase)
    native_io.write_file(names[rank], hdr + body)
    return _written(g, names)


# ---------------- new-style banded dumps (field_dump/hydro_dump with
# strides + global header, dump.cc:518+ / dumpmacros.h:43-64) ----------------

def _global_header(g: Grid, stride, shp) -> str:
    return (f"topology {g.topology[0]} {g.topology[1]} {g.topology[2]}\n"
            f"stride {stride[0]} {stride[1]} {stride[2]}\n"
            f"local_dims {shp[2]} {shp[1]} {shp[0]}\n")


def dump_fields_strided(sim, state, fbase: str, stride=(1, 1, 1),
                        components=None, ftag: Optional[int] = None):
    """New-style stride-subsampled band-sequential field dump (the
    "dumpParams" field_dump path, dump.cc:518-660): the binary of the
    selected component bands subsampled over interior voxels
    [1 : n+1 : stride], plus a ``{fbase}.{tag}.global`` text header
    recording topology, strides, band order and the file names."""
    g = sim.grid
    rank = _rank(g)
    step = int(state.step)
    tag = step if ftag is None else ftag
    comps = list(components) if components is not None else list(FIELD_BANDS)
    for c in comps:
        if c not in FIELD_BANDS:
            raise ValueError(f"unknown field component {c!r}")
    sx, sy, sz = (int(v) for v in stride)
    bands = [np.ascontiguousarray(
        _host(getattr(state.fields, c))[1:g.nz + 1:sz, 1:g.ny + 1:sy,
                                        1:g.nx + 1:sx], "<f4")
        for c in comps]
    shp = bands[0].shape
    hdr = _header_v0(g, step, DUMP_FIELDS, rank=rank)
    hdr += _array_header(4 * len(comps), [shp[2], shp[1], shp[0]])
    names = _names(g, f"{fbase}.{tag}")
    native_io.write_file(names[rank],
                         hdr + b"".join(b.tobytes() for b in bands))
    if rank == 0:
        with open(f"{fbase}.{tag}.global", "w") as fh:
            fh.write(f"step {step}\n")
            fh.write(f"grid {g.gnx} {g.gny} {g.gnz}\n")
            fh.write(_global_header(g, (sx, sy, sz), shp))
            fh.write("bands " + " ".join(comps) + "\n")
            fh.write("files " + " ".join(names) + "\n")
    return _written(g, names)


def dump_hydro_strided(sim, state, sp_name: str, fbase: str,
                       stride=(1, 1, 1), ftag: Optional[int] = None):
    """New-style stride-subsampled band-sequential hydro dump (hydro_dump
    with dumpParams, dump.cc:662+); the bands are the 14 hydro moments."""
    g = sim.grid
    rank = _rank(g)
    step = int(state.step)
    tag = step if ftag is None else ftag
    k = _species_index(sim, sp_name)
    spp = sim.species[k].params
    sx, sy, sz = (int(v) for v in stride)
    a = _host(H.compute_hydro(sim, state, k)).reshape(
        g.NZ, g.NY, g.NX, H.N_HYDRO)
    a = a[1:g.nz + 1:sz, 1:g.ny + 1:sy, 1:g.nx + 1:sx]
    shp = a.shape[:3]
    bands = np.ascontiguousarray(np.moveaxis(a, 3, 0), "<f4")
    hdr = _header_v0(g, step, DUMP_HYDRO, sp_id=spp.id, q_m=spp.q / spp.m,
                     rank=rank)
    hdr += _array_header(4 * H.N_HYDRO, [shp[2], shp[1], shp[0]])
    names = _names(g, f"{fbase}.{tag}")
    native_io.write_file(names[rank], hdr + bands.tobytes())
    if rank == 0:
        with open(f"{fbase}.{tag}.global", "w") as fh:
            fh.write(f"step {step}\nspecies {sp_name}\n")
            fh.write(_global_header(g, (sx, sy, sz), shp))
            fh.write(f"bands {H.N_HYDRO}\n")
            fh.write("files " + " ".join(names) + "\n")
    return _written(g, names)
