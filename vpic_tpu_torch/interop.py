"""State carried across between the JAX package and the port, as numpy.

``state_from_numpy`` takes a ``vpic_tpu`` ``SimState`` whose leaves are
numpy arrays (what ``jax.device_get(state)`` returns) and builds the port's
``SimState`` on a device; ``state_to_numpy`` goes the other way, to plain
dicts of numpy arrays.  Every ``diag`` entry moves both ways, the boundary
handlers' counters and link buffers included.  ``vbc_from_numpy`` takes a
per-voxel-face particle-BC code table (the JAX package's
``Simulation._vbc``).  Neither imports the JAX package: the input is read
by attribute (or key) names, which both packages share.  Values move
bit-exactly; ``i`` stays int32 and ``live`` bool.

Decomposed states: the JAX package's global sharded state carries the
leading ``(px, py, pz)`` dims on every leaf; ``state_from_numpy(...,
rank=r)`` takes flat rank r's brick of it (x-major, z-minor), and
``gather_to_numpy(state, g)`` gathers every rank's state to rank 0 in that
layout (None on the other ranks).
"""

from __future__ import annotations

import numpy as np
import torch

from .state import (FIELD_NAMES, SPECIES_NAMES, FieldState, SimState,
                    SpeciesState)


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _tensor(a, device, dtype=None):
    arr = np.array(a, order="C")     # a C-ordered copy; 0-d stays 0-d
    if dtype is not None and arr.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {arr.dtype}")
    return torch.from_numpy(arr).to(device)


_SPECIES_DTYPES = dict(dx=np.float32, dy=np.float32, dz=np.float32,
                       i=np.int32, ux=np.float32, uy=np.float32,
                       uz=np.float32, w=np.float32, live=np.bool_,
                       np=np.int32)


# diag entries the port keeps as host values, not device tensors
HOST_DIAG = {"_res_valid": bool}


def _diag_value(name, v, device):
    if name in HOST_DIAG:
        return HOST_DIAG[name](np.asarray(v))
    return _tensor(v, device)


def _pick(np_state, rank: int):
    """Flat rank ``rank``'s brick of a state whose leaves carry the leading
    (px, py, pz) dims, as a dict."""
    f = _get(np_state, "fields")
    px, py, pz = np.shape(_get(f, "ex"))[:3]
    idx = (rank // (py * pz), (rank // pz) % py, rank % pz)
    pick = lambda a: None if a is None else np.asarray(a)[idx]
    rng = (np_state.get("rng") if isinstance(np_state, dict)
           else getattr(np_state, "rng", None))
    return dict(
        fields={n: pick(_get(f, n)) for n in FIELD_NAMES},
        species=[{n: pick(_get(sp, n)) for n in SPECIES_NAMES}
                 for sp in _get(np_state, "species")],
        step=pick(_get(np_state, "step")),
        diag={k: pick(v) for k, v in (_get(np_state, "diag") or {}).items()},
        rng=None if rng is None else pick(rng))


def state_from_numpy(np_state, device="cuda", rank: int = None) -> SimState:
    """A numpy-leaved SimState (object or dict) -> the port's SimState on
    ``device`` (the card unless the caller asks for the CPU); with
    ``rank``, that flat rank's brick of a decomposed (leading (px, py,
    pz) dims) state."""
    if rank is not None:
        np_state = _pick(np_state, rank)
    f = _get(np_state, "fields")
    fields = FieldState(**{n: _tensor(_get(f, n), device, np.float32)
                           for n in FIELD_NAMES})
    species = tuple(
        SpeciesState(**{n: _tensor(_get(sp, n), device, _SPECIES_DTYPES[n])
                        for n in SPECIES_NAMES})
        for sp in _get(np_state, "species"))
    diag = _get(np_state, "diag") or {}
    rng = (np_state.get("rng") if isinstance(np_state, dict)
           else getattr(np_state, "rng", None))
    return SimState(fields=fields, species=species,
                    step=int(np.asarray(_get(np_state, "step"))),
                    diag={k: _diag_value(k, v, device)
                          for k, v in diag.items()},
                    rng=None if rng is None else np.array(rng, np.uint32))


def state_to_numpy(state: SimState) -> dict:
    """The port's SimState -> {"fields": {...}, "species": [{...}, ...],
    "step": int, "diag": {...}, "rng": key or None} of numpy arrays."""
    host = lambda t: (t.detach().cpu().numpy().copy()
                      if isinstance(t, torch.Tensor) else np.asarray(t))
    return dict(
        fields={n: host(getattr(state.fields, n)) for n in FIELD_NAMES},
        species=[{n: host(getattr(sp, n)) for n in SPECIES_NAMES}
                 for sp in state.species],
        step=int(state.step),
        diag={k: host(v) for k, v in state.diag.items()},
        rng=None if state.rng is None else np.array(state.rng, np.uint32))


def gather_to_numpy(state: SimState, g) -> dict:
    """Every rank's ``state`` as one state_to_numpy dict with the leading
    (px, py, pz) dims, on rank 0 (None on the others); every rank makes
    the call.  An undecomposed grid's state comes back as state_to_numpy
    gives it."""
    host = state_to_numpy(state)
    if not g.sharded:
        return host
    from .checkpoint import _gather
    from .parallel.mesh import mesh_of
    m = mesh_of(g)
    out = dict(
        fields={n: _gather(m, g, a) for n, a in host["fields"].items()},
        species=[{n: _gather(m, g, a) for n, a in sp.items()}
                 for sp in host["species"]],
        step=_gather(m, g, np.int32(host["step"])),
        diag={k: _gather(m, g, v) for k, v in host["diag"].items()},
        rng=None if host["rng"] is None else _gather(m, g, host["rng"]))
    return out if m.rank == 0 else None


def vbc_from_numpy(vbc, device="cuda") -> torch.Tensor:
    """A (NZ, NY, NX, 6), (nv, 6) or flat (nv * 6,) int32 per-voxel-face
    particle-BC code table -> the port's (nv, 6) int32 table on
    ``device``."""
    arr = np.array(vbc, order="C")
    if arr.dtype != np.int32:
        raise TypeError(f"expected int32, got {arr.dtype}")
    if arr.size % 6:
        raise ValueError(f"{arr.size} codes are not 6 per voxel")
    return torch.from_numpy(arr.reshape(-1, 6)).to(device)
