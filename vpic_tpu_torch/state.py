"""Simulation state as dataclasses of torch tensors (counterpart of
``vpic_tpu/state.py``).

* ``FieldState``    <- ``field_t`` (field_advance.h:152-160) as SoA full-grid
  tensors ``[z, y, x]`` (ghosted).
* ``MaterialCoeffs`` <- ``material_coefficient_t`` (sfa_private.h:14-29).
  A single material fills all space, so every entry is a 0-d float32 tensor
  that broadcasts (the vacuum fast path, sfa.c:202-211).
* ``SpeciesState``  <- ``species_t`` + ``particle_t`` as fixed-capacity SoA
  tensors with a live mask; dead slots have w = 0 and voxel 0, a ghost cell,
  so they deposit nothing.
* ``SimState``      <- the dynamic members of ``vpic_simulation``.

The port's step functions update these tensors in place where that saves
memory traffic, and say so in their docstrings.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .grid import Grid

FIELD_NAMES = ("ex", "ey", "ez", "cbx", "cby", "cbz", "tcax", "tcay", "tcaz",
               "jfx", "jfy", "jfz", "rhof", "rhob", "div_e_err", "div_b_err")
SPECIES_NAMES = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live", "np")


@dataclass
class FieldState:
    """All field-mesh quantities, each shaped ``grid.shape = (nz+2, ny+2, nx+2)``
    float32.  Yee staggering as in ``vpic_tpu.state.FieldState``."""

    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    cbx: torch.Tensor
    cby: torch.Tensor
    cbz: torch.Tensor
    tcax: torch.Tensor
    tcay: torch.Tensor
    tcaz: torch.Tensor
    jfx: torch.Tensor
    jfy: torch.Tensor
    jfz: torch.Tensor
    rhof: torch.Tensor
    rhob: torch.Tensor
    div_e_err: torch.Tensor
    div_b_err: torch.Tensor

    @classmethod
    def zeros(cls, g: Grid, device) -> "FieldState":
        return cls(*[torch.zeros(g.shape, dtype=torch.float32, device=device)
                     for _ in FIELD_NAMES])

    def replace(self, **kw) -> "FieldState":
        return dataclasses.replace(self, **kw)


@dataclass
class MaterialCoeffs:
    """advance_e / div-clean coefficients (sfa.c:112-148), each a 0-d
    float32 tensor on the simulation's device."""

    decayx: torch.Tensor
    decayy: torch.Tensor
    decayz: torch.Tensor
    drivex: torch.Tensor
    drivey: torch.Tensor
    drivez: torch.Tensor
    rmux: torch.Tensor
    rmuy: torch.Tensor
    rmuz: torch.Tensor
    nonconductive: torch.Tensor
    epsx: torch.Tensor
    epsy: torch.Tensor
    epsz: torch.Tensor


@dataclass
class SpeciesState:
    """Fixed-capacity SoA particle storage for one species.

    dx,dy,dz: voxel-centered offsets in [-1,1] (species_advance_aos.h:23-26)
    i:        local voxel linear index (int32)
    ux,uy,uz: normalized momentum (gamma * beta)
    w:        macro-particle weight
    live:     bool (N,): slot holds a live particle
    np:       0-d int32 tensor, the number of live slots (read it on the
              host only where the host needs it: it costs a device sync)
    """

    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    i: torch.Tensor
    ux: torch.Tensor
    uy: torch.Tensor
    uz: torch.Tensor
    w: torch.Tensor
    live: torch.Tensor
    np: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.dx.shape[0]

    def replace(self, **kw) -> "SpeciesState":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SpeciesParams:
    """Static species parameters (species_t scalars, species_advance_aos.h:56-66)."""

    name: str
    q: float
    m: float
    capacity: int
    sort_interval: int = 0
    id: int = 0


@dataclass
class SimState:
    """Dynamic simulation state: everything a timestep reads and writes.

    ``step`` is a host int: every cadence decision (sort, cleaners) is made
    on the host from it.  ``diag`` holds named device tensors (counters, the
    3-D home maps) and one host bool, ``_res_valid`` (the residency layout
    is set up); its keys are fixed at initialize().  ``rng`` is the JAX
    package's state key, a host uint32 numpy array the port only carries
    (from initialize() or a restored checkpoint) so that its checkpoints
    give ``vpic_tpu`` the key it expects; the port's randoms come from the
    Simulation's ``torch.Generator``."""

    fields: FieldState
    species: Tuple[SpeciesState, ...]
    step: int = 0
    diag: Dict[str, object] = dataclasses.field(default_factory=dict)
    rng: Optional[np.ndarray] = None

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)
