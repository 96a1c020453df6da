"""The deck layer: VPIC's input-deck vocabulary as a Python builder
(counterpart of ``vpic_tpu/deck.py``: the 2-D and 3-D kernel paths, the
3-D residency path and the general path, on one domain or decomposed).

A deck is ordinary Python driving a ``Simulation`` builder with the
reference's vocabulary (define_units, define_timestep,
define_periodic_grid, set_domain_field_bc, define_material,
define_field_array, define_species, set_region_field, inject_particle, ...).
``initialize()`` turns it into a ``SimState`` of tensors on
``Simulation.device`` -- the CUDA card unless the caller asks for the CPU --
and ``make_advance()`` returns the step (src/vpic/advance.cc:15-208).
Particle boundaries: built-in and custom (``boundary_ops`` handlers) domain
faces (set_domain_particle_bc, define_absorbing_grid), region surfaces
(set_region_particle_bc, a per-voxel-face code table), and the user field
and current injection hooks.  Particle sources and sinks of momentum:
``collision_ops`` (``collision``) and the user_particle_collisions hook
before the push, the emitters (define_surface_emitter,
define_volume_emitter; ``emitter``) and the user_particle_injection hook
after it, and aged injection (inject_particle(age=)).  Their randoms come
from the Simulation's ``torch.Generator``, made at initialize().

Host-side staging (particle injection, region rasterization) runs in numpy
at double precision exactly like the JAX package, so the same deck and seed
give bit-equal initial particle and field arrays in both packages.  The
step's cadence decisions (sorts, cleaners, collision firings, the residency
relayout) are made on the host from the host-int ``state.step`` and form its
``Cadence``.  The step is graph-safe: every tensor it carries from step to
step keeps its storage (the accumulator is allocated once, new sorts and
diag counts are copied into the state's tensors), so ``step_graph`` can
capture it as CUDA graphs, one per cadence.  The 3-D residency step's
rebucket-or-merge (the JAX package's ``lax.cond``) is then two conditional
nodes on a device bool; run eagerly it reads that bool, one host read a
step, counted in ``Simulation.host_syncs``.

Decomposed grids (a topology other than (1, 1, 1)) run one process per
rank (``parallel/mesh.py``): every rank runs the whole deck, stages the
same global load and keeps its own brick's lanes, fields, materials and
region tables; the step is the JAX package's shard-local step, with the
halo exchanges of ``ops/fields`` and the migration rounds of
``boundary.boundary_p``, and ``energies`` sums over the ranks.  Residency
is off there (lanes move between ranks every step), so a 3-D deck
brick-sorts every step.  The collision ops run on each rank's lanes, and
the emitters and the injection hook run before boundary_p's migration
rounds, as the JAX package's sharded step orders them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field as dfield
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import boundary as B
from . import step_graph as SG
from .grid import (ABSORB_PARTICLES, FIRST_CUSTOM_PBC, P_PERIODIC,
                   PERIODIC, REFLECT_PARTICLES, Grid, cartesian_partners,
                   flat_rank, local_corner, partition_absorbing_box,
                   partition_metal_box, partition_periodic_box,
                   rank_coords)
from .ops import field_fuse as FF
from .ops import fields as F
from .ops import fused_push as FP
from .ops import fused_push3d as FP3
from .ops import interp as I
from .ops import move_p as MP
from .ops import push as P
from .ops import residency as RES
from .ops import rho_p as RHO
from .parallel.mesh import mesh_of
from .utils import profile as PF
from .state import (FIELD_NAMES, SPECIES_NAMES, FieldState, MaterialCoeffs,
                    SimState, SpeciesParams, SpeciesState)

everywhere = lambda x, y, z: True

# the field_t member order of the 8 material-id meshes
# (field_advance.h:152-160)
MAT_ID_ORDER = ("ematx", "ematy", "ematz", "nmat",
                "fmatx", "fmaty", "fmatz", "cmat")


class Cadence(NamedTuple):
    """The host-side decisions of one step, from its step number and the
    residency flag: the 2-D bucket sort, the general path's per-species
    sort_p, each collision op's firing, the residency relayout before the
    push (the first step, a restore without the layout, a firing step), and
    the three cleaners.  Steps with equal cadences run the same kernels on
    the same tensors, so one CUDA graph serves them (step_graph)."""
    sort: bool
    sorts: Tuple[bool, ...]
    fire: Tuple[bool, ...]
    relayout: bool
    clean_e: bool
    clean_b: bool
    sync: bool


def _keep(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``src``'s values in ``dst``'s storage (nothing to do where they are
    one tensor already); returns dst."""
    if src is not dst and not (src.data_ptr() == dst.data_ptr()
                               and src.shape == dst.shape
                               and src.stride() == dst.stride()):
        dst.copy_(src)
    return dst


def _keep_species(home: SpeciesState, sp: SpeciesState) -> SpeciesState:
    """``sp`` in ``home``'s tensors (lanes and np); returns home."""
    for n in SPECIES_NAMES:
        _keep(getattr(home, n), getattr(sp, n))
    return home


@dataclass
class Material:
    name: str
    epsx: float = 1.0
    epsy: float = 1.0
    epsz: float = 1.0
    mux: float = 1.0
    muy: float = 1.0
    muz: float = 1.0
    sigmax: float = 0.0
    sigmay: float = 0.0
    sigmaz: float = 0.0
    zetax: float = 0.0
    zetay: float = 0.0
    zetaz: float = 0.0
    id: int = 0


@dataclass
class _StagedSpecies:
    """Host-staged injections, in injection order: rows (dx, dy, dz, ix,
    iy, iz, ux, uy, uz, w, age, update_rhob), the JAX package's."""
    params: SpeciesParams
    xs: list = dfield(default_factory=list)

    @property
    def count(self) -> int:
        return len(self.xs)


class Simulation:
    """vpic_simulation analogue (src/vpic/vpic.h:120-671).

    ``device`` is where initialize() puts the state: the CUDA card by
    default; pass ``device="cpu"`` to run the plain PyTorch versions on the
    CPU.  Without a card the default raises at initialize(); it never falls
    back to the CPU."""

    def __init__(self, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.seed = seed
        self.grid: Optional[Grid] = None
        self.materials: List[Material] = []
        self.species: List[_StagedSpecies] = []
        self.damp = 0.0
        self._cvac = 1.0
        self._eps0 = 1.0
        self._dt = 0.0
        # High-level step-loop parameters (vpic.h:133-173)
        self.num_step = 0
        self.status_interval = 0
        self.sync_shared_interval = 0
        self.clean_div_e_interval = 0
        self.clean_div_b_interval = 0
        self.num_div_e_round = 2
        self.num_div_b_round = 2
        self.max_streak = 4
        # handler runs after the (one-device: empty) migration rounds of
        # the general path's boundary_p (vpic.cc:79)
        self.num_comm_round = 3
        # bucket-sort cadence of the fused path (vpic_tpu's
        # pallas_sort_interval; the per-species sort_interval drives only
        # the JAX package's general path)
        self.pallas_sort_interval = 8
        # host reads of the device made by the step (the residency trigger,
        # and on a decomposed grid the collectives' copies and counts)
        self.host_syncs = 0
        self._mesh_syncs = 0
        # migration rounds on a decomposed grid: lanes sent (host int) and
        # lanes dropped (a device tensor; 0 unless a buffer overflowed)
        self.migration = {"migrated": 0, "n_dropped": 0}
        self._field_ops: list = []
        # User hooks (deck sections): (FieldState, step) -> FieldState; they
        # may update the fields in place and return them.
        self.user_field_injection = None
        self.user_current_injection = None
        # Particle sources and collisions (advance.cc:45-60): ops
        # (species, f, g, step, generator[, diag]) run before the push in
        # list order; emitters (species, f, fcoef, acc, rhob, g, step,
        # generator) -> (species, acc, rhob) run after it
        self.collision_ops: list = []
        self.emitters: list = []
        # (species, f, g, step, generator) -> species, after the ops; the
        # JAX package's hook takes and returns a key where this takes the
        # generator
        self.user_particle_collisions = None
        # (species, f, fcoef, acc, rhob, g, step, generator) -> (species,
        # acc, rhob), after the emitters (begin_particle_injection); the
        # JAX package's takes and returns a key
        self.user_particle_injection = None
        # pre-push residency sorts: the first step's, a restore's without
        # the layout, and one on every step a collision op fires
        self.relayouts = 0
        # registry key -> custom particle-BC handler: 0-5 domain faces,
        # 6 + 6 h + face region surface h (boundary_ops)
        self.pbc_handlers: dict = {}
        # per-voxel-face particle-BC codes (grid.h:116-121 neighbor
        # analogue): (NZ, NY, NX, 6) int32, or None
        self._vbc = None
        self._n_region_pbc = 0
        # the handlers' randoms: made and seeded from ``seed`` at
        # initialize(), on ``device``
        self._generator = None
        self._entropy = np.random.RandomState(seed)
        # the pool every rank draws alike (sync_rng); every rank runs the
        # deck with rank 0's pools, so all stage the same global load
        self._sync_entropy = np.random.RandomState(seed + 0x5EED)
        self._rank = 0
        # materials: the stagger-class id meshes (set at
        # define_field_array), and the coefficients built from them once:
        # (grid, device, MaterialCoeffs), dropped when a material changes
        self._mat_ids = None
        self._multi_material = False
        self._mcoef = None

    # ---------------- units / grid ----------------

    def seed_entropy(self, seed: int):
        self._entropy = np.random.RandomState(seed + self._rank)
        self._sync_entropy = np.random.RandomState(seed + 0x5EED)

    def rng(self, _i: int = 0) -> np.random.RandomState:
        """Deck-level host RNG pool handle (rng(i) in decks)."""
        return self._entropy

    def sync_rng(self, _i: int = 0) -> np.random.RandomState:
        """The host RNG pool that draws alike on every rank (sync_rng(i) in
        decks)."""
        return self._sync_entropy

    def uniform(self, rng, lo, hi):
        return lo + (hi - lo) * rng.random_sample()

    def normal(self, rng, mu, sigma):
        return mu + sigma * rng.standard_normal()

    def define_units(self, cvac: float, eps0: float):
        self._cvac = float(cvac)
        self._eps0 = float(eps0)

    def define_timestep(self, dt: float):
        self._dt = float(dt)

    def courant_length(self, lx, ly, lz, nx, ny, nz):
        s = 0.0
        if nx > 1:
            s += (nx / lx) ** 2
        if ny > 1:
            s += (ny / ly) ** 2
        if nz > 1:
            s += (nz / lz) ** 2
        return s ** -0.5

    def define_periodic_grid(self, lo, hi, n, topology=(1, 1, 1)):
        self.grid = partition_periodic_box(
            *lo, *hi, *[int(v) for v in n], *[int(v) for v in topology],
            dt=self._dt, cvac=self._cvac, eps0=self._eps0)
        return self.grid

    def define_absorbing_grid(self, lo, hi, n, topology=(1, 1, 1),
                              pbc=ABSORB_PARTICLES):
        self.grid = partition_absorbing_box(
            *lo, *hi, *[int(v) for v in n], *[int(v) for v in topology],
            pbc=pbc, dt=self._dt, cvac=self._cvac, eps0=self._eps0)
        return self.grid

    def define_reflecting_grid(self, lo, hi, n, topology=(1, 1, 1)):
        self.grid = partition_metal_box(
            *lo, *hi, *[int(v) for v in n], *[int(v) for v in topology],
            dt=self._dt, cvac=self._cvac, eps0=self._eps0)
        return self.grid

    def size_domain(self, nx, ny, nz):
        """size_domain (vpic.h:380): a particle-reflecting metal box of unit
        spacing at the origin; the deck then sets the corner and spacings
        with set_domain_geometry and the faces with set_domain_field_bc /
        join_domain, the reference's size_domain -> grid->x0/dx ->
        set_fbc/join_grid order."""
        self.grid = partition_metal_box(
            0.0, 0.0, 0.0, float(nx), float(ny), float(nz),
            int(nx), int(ny), int(nz), 1, 1, 1,
            dt=self._dt, cvac=self._cvac, eps0=self._eps0)
        return self.grid

    def set_domain_geometry(self, x0=None, y0=None, z0=None,
                            dx=None, dy=None, dz=None):
        """Set the grid's corner and spacings, as a deck writes grid->x0 and
        grid->dx (sample/cygnus:88-95).  The Grid keeps corners, so a
        spacing dx becomes x1 = x0 + dx * gnx."""
        g = self.grid
        lo = [g.x0 if x0 is None else float(x0),
              g.y0 if y0 is None else float(y0),
              g.z0 if z0 is None else float(z0)]
        hi = [v + (float(d) * n if d is not None else a1 - a0)
              for v, d, n, a0, a1 in zip(
                  lo, (dx, dy, dz), (g.gnx, g.gny, g.gnz),
                  (g.x0, g.y0, g.z0), (g.x1, g.y1, g.z1))]
        self.grid = dataclasses.replace(g, x0=lo[0], y0=lo[1], z0=lo[2],
                                        x1=hi[0], y1=hi[1], z1=hi[2])
        return self.grid

    def join_domain(self, boundary: int, rank: int, src_rank: int = 0):
        """join_domain (grid/ops.c:119 join_grid): connect a face to
        another domain's opposite face.
        - self-join (rank == src_rank): the face's axis becomes periodic in
          both faces (sample/cygnus:96-97's y periodicity of a 2-D deck).
        - rank != src_rank: an irregular domain graph (vpic_tpu/deck.py:
          232-300).  The grid's per-face partner tables (seeded from the
          cartesian topology the first time) record that src_rank's
          ``boundary`` face connects to ``rank``'s opposite face; halo
          exchange and migration then follow the tables.  Joins are
          reciprocal: the opposite entry on ``rank`` is updated and any
          stale link unspliced, so each face's map stays a permutation."""
        face = int(boundary)
        if rank == src_rank:
            axis = face % 3
            for fc in (axis, axis + 3):
                self.grid = self.grid.with_bc(fc, fbc=PERIODIC,
                                              pbc=P_PERIODIC)
            return self.grid
        g = self.grid
        n = g.n_shards
        if not (0 <= rank < n and 0 <= src_rank < n):
            raise ValueError(
                f"join_domain({face}, {rank}, {src_rank}): ranks must be "
                f"< n_shards ({n}); partition with a topology covering "
                "every domain first")
        tabs = [list(t) for t in (g.face_partners or cartesian_partners(g))]
        opp = (face + 3) % 6

        def unlink(fc, r):
            p = tabs[fc][r]
            if p >= 0 and tabs[(fc + 3) % 6][p] == r:
                tabs[(fc + 3) % 6][p] = -1
            tabs[fc][r] = -1

        unlink(face, src_rank)
        unlink(opp, rank)
        tabs[face][src_rank] = rank
        tabs[opp][rank] = src_rank
        self.grid = dataclasses.replace(
            g, face_partners=tuple(tuple(t) for t in tabs))
        return self.grid

    def set_domain_field_bc(self, face: int, bc: int):
        self.grid = self.grid.with_bc(face, fbc=bc)

    def set_domain_particle_bc(self, face: int, bc):
        """bc: a built-in code (reflect/absorb/...) or a custom handler
        built by ``boundary_ops`` (maxwellian_reflux, absorb_tally, ...),
        registered under key ``face`` (vpic.h:510-530)."""
        if callable(bc):
            self.pbc_handlers[face] = bc
            bc = FIRST_CUSTOM_PBC - len(self.pbc_handlers) + 1
        self.grid = self.grid.with_bc(face, pbc=bc)

    def define_surface_emitter(self, emitter_factory, region,
                               sp: SpeciesParams, **kw):
        """define_surface_emitter (deck/wrapper.h:310-383): scan the
        region's surface into a static component list and register the
        emission op ``emitter_factory(sp.id, sp, components, **kw)``."""
        from . import emitter as E
        op = emitter_factory(sp.id, sp, E.surface_components(self.grid,
                                                             region), **kw)
        self.emitters.append(op)
        return op

    def define_volume_emitter(self, emitter_factory, region,
                              sp: SpeciesParams, **kw):
        """define_volume_emitter (deck/wrapper.h:348-383): every face of
        every in-region cell becomes an emission component."""
        from . import emitter as E
        op = emitter_factory(sp.id, sp, E.volume_components(self.grid,
                                                            region), **kw)
        self.emitters.append(op)
        return op

    def set_region_particle_bc(self, region, bc):
        """Attach a particle BC to the surface of an interior region (the
        reference's per-voxel neighbor-table encoding, grid.h:116-121,
        decoded at boundary_p.cc:196-255).  Every voxel face between a cell
        inside the region and a cell outside it gets the code on both sides
        (the exit face of either cell).  ``bc`` is REFLECT_PARTICLES,
        ABSORB_PARTICLES, or a ``boundary_ops`` handler, registered under
        keys 6 + 6 h + face and parked with pend CUSTOM_BASE + key."""
        g = self.grid
        if callable(bc):
            h = self._n_region_pbc
            self._n_region_pbc += 1
            for f in range(6):
                self.pbc_handlers[6 + 6 * h + f] = bc
            codes = [P.CUSTOM_BASE + 6 + 6 * h + f for f in range(6)]
        else:
            if int(bc) not in (ABSORB_PARTICLES, REFLECT_PARTICLES):
                raise ValueError("set_region_particle_bc: bc must be "
                                 "ABSORB/REFLECT or a handler")
            codes = [int(bc)] * 6
        if self._vbc is None:
            self._vbc = np.zeros((g.NZ, g.NY, g.NX, 6), np.int32)
        inside = self._region_mask(region)
        vb = self._vbc
        for ax in range(3):
            a = 2 - ax                   # grid axis -> array axis
            last = (slice(None),) * a + (-1,)
            # neighbour in +ax: nb_hi[v] = inside[v + 1]
            nb_hi = np.roll(inside, -1, axis=a)
            nb_hi[last] = inside[last]
            face_hi = inside != nb_hi    # an in/out face above v
            # exit face ax + 3 seen from v, face ax seen from v + 1
            vb[..., ax + 3][face_hi] = codes[ax + 3]
            lo_of_upper = np.roll(face_hi, 1, axis=a)
            lo_of_upper[(slice(None),) * a + (0,)] = False
            vb[..., ax][lo_of_upper] = codes[ax]

    def _region_mask(self, region):
        """``region`` at the ghosted cell centres of this rank's brick, a
        (NZ, NY, NX) bool array: on a decomposed grid each rank rasterizes
        its own brick with its global offsets (vpic_tpu/deck.py:352-381)."""
        g = self.grid
        x0, y0, z0 = local_corner(g, flat_rank(g))
        xc = x0 + g.dx * (np.arange(g.NX) - 0.5)
        yc = y0 + g.dy * (np.arange(g.NY) - 0.5)
        zc = z0 + g.dz * (np.arange(g.NZ) - 0.5)
        Z, Y, X = np.meshgrid(zc, yc, xc, indexing="ij")
        return np.vectorize(region, otypes=[bool])(X, Y, Z)

    def _local_vbc(self):
        """The (nv, 6) int32 per-voxel-face code table on the device, or
        None."""
        if self._vbc is None:
            return None
        return torch.from_numpy(self._vbc.reshape(-1, 6)).to(self.device)

    # ---------------- materials / field array ----------------

    def define_material(self, name, eps=1.0, mu=1.0, sigma=0.0, zeta=0.0,
                        **tensor) -> Material:
        self._mcoef = None

        def three(v):
            return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)

        ex, ey, ez = three(tensor.get("eps", eps))
        mx, my, mz = three(tensor.get("mu", mu))
        sx, sy, sz = three(tensor.get("sigma", sigma))
        zx, zy, zz = three(tensor.get("zeta", zeta))
        m = Material(name, ex, ey, ez, mx, my, mz, sx, sy, sz, zx, zy, zz,
                     id=len(self.materials))
        self.materials.append(m)
        return m

    def lookup_material(self, name: str) -> Material:
        for m in self.materials:
            if m.name == name:
                return m
        raise KeyError(name)

    def define_field_array(self, _kernels=None, damp: float = 0.0):
        self.damp = float(damp)
        self._field_ops = []
        # Material-id meshes at the 8 stagger classes (field_t material
        # members, field_advance.h:152-160), filled by set_region_material.
        self._mat_ids = self._zero_mat_ids()
        self._multi_material = False
        self._mcoef = None

    def _zero_mat_ids(self):
        g = self.grid
        return None if g is None else {k: np.zeros(g.shape, np.int16)
                                       for k in MAT_ID_ORDER}

    def set_region_material(self, region, volume_mat, surface_mat=None):
        """set_region_material (deck/wrapper.h:211-253): the volume material
        at every stagger location fully inside the region, the surface
        material at locations partly inside, from ``region`` evaluated at
        the ghosted cell centres of this rank's brick (numpy, on the
        host)."""
        if isinstance(volume_mat, str):
            volume_mat = self.lookup_material(volume_mat)
        if isinstance(surface_mat, str):
            surface_mat = self.lookup_material(surface_mat)
        if surface_mat is None:
            surface_mat = volume_mat
        if self._mat_ids is None:
            self._mat_ids = self._zero_mat_ids()
        self._multi_material = True
        self._mcoef = None
        inside = self._region_mask(region)

        def sh(dz, dy, dx):
            """out[v] = inside[v - d], False beyond the array edge."""
            NZ, NY, NX = inside.shape
            out = np.zeros_like(inside)
            out[dz:, dy:, dx:] = inside[:NZ - dz, :NY - dy, :NX - dx]
            return out

        # the cells around each stagger location: c the voxel's own, l the
        # one below it along x, y, z in that order of the three letters
        ccc, lcc, clc, llc = inside, sh(0, 0, 1), sh(0, 1, 0), sh(0, 1, 1)
        ccl, lcl, cll, lll = sh(1, 0, 0), sh(1, 0, 1), sh(1, 1, 0), sh(1, 1, 1)
        combos = dict(
            ematx=(ccc, clc, ccl, cll), ematy=(ccc, ccl, lcc, lcl),
            ematz=(ccc, lcc, clc, llc), fmatx=(ccc, lcc),
            fmaty=(ccc, clc), fmatz=(ccc, ccl),
            nmat=(ccc, lcc, clc, llc, ccl, lcl, cll, lll))
        for name, cells in combos.items():
            ids = self._mat_ids[name]
            ids[np.logical_or.reduce(cells)] = surface_mat.id
            ids[np.logical_and.reduce(cells)] = volume_mat.id
        self._mat_ids["cmat"][ccc] = volume_mat.id

    def _axis_coeffs(self, sigma, eps):
        """Exponential differencing coefficients (sfa.c:115-133)."""
        g = self.grid
        ax = (sigma * g.dt) / (eps * g.eps0)
        decay = math.exp(-ax)
        if ax == 0:
            drive = 1.0 / eps
        elif decay == 0:
            drive = 0.0
        else:
            drive = 2.0 * math.exp(-0.5 * ax) * math.sinh(0.5 * ax) / (ax * eps)
        return decay, drive

    def _material_coeffs(self) -> MaterialCoeffs:
        """create_sfa_params (sfa.c:55-151) as device tensors on
        ``device``, built once and kept until a material, the grid or the
        device changes.  One material filling all space gives 0-d
        coefficients (the vacuum fast-kernel analogue, sfa.c:202-211);
        region-assigned materials pre-expand the per-material tables onto
        the stagger-matched id meshes (3-D coefficients, as the JAX
        package)."""
        if not self.materials:
            raise RuntimeError("no materials defined")
        if self._mcoef is not None and \
                self._mcoef[:2] == (self.grid, self.device):
            return self._mcoef[2]
        t = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                      device=self.device)
        nm = len(self.materials)
        decay = np.zeros((nm, 3), np.float32)
        drive = np.zeros((nm, 3), np.float32)
        rmu = np.zeros((nm, 3), np.float32)
        noncond = np.zeros((nm,), np.float32)
        eps = np.zeros((nm, 3), np.float32)
        for m in self.materials:
            for a, (sg, ep) in enumerate(((m.sigmax, m.epsx),
                                          (m.sigmay, m.epsy),
                                          (m.sigmaz, m.epsz))):
                decay[m.id, a], drive[m.id, a] = self._axis_coeffs(sg, ep)
            rmu[m.id] = (1.0 / m.mux, 1.0 / m.muy, 1.0 / m.muz)
            eps[m.id] = (m.epsx, m.epsy, m.epsz)
            noncond[m.id] = 1.0 if (m.sigmax == 0 and m.sigmay == 0
                                    and m.sigmaz == 0) else 0.0
        if not self._multi_material:
            # material 0 fills all space: 0-d coefficients
            ids = {k: 0 for k in MAT_ID_ORDER}
        else:
            ids = self._mat_ids
        coeffs = MaterialCoeffs(
            decayx=t(decay[ids["ematx"], 0]), decayy=t(decay[ids["ematy"], 1]),
            decayz=t(decay[ids["ematz"], 2]),
            drivex=t(drive[ids["ematx"], 0]), drivey=t(drive[ids["ematy"], 1]),
            drivez=t(drive[ids["ematz"], 2]),
            rmux=t(rmu[ids["fmatx"], 0]), rmuy=t(rmu[ids["fmaty"], 1]),
            rmuz=t(rmu[ids["fmatz"], 2]),
            nonconductive=t(noncond[ids["nmat"]]),
            epsx=t(eps[ids["ematx"], 0]), epsy=t(eps[ids["ematy"], 1]),
            epsz=t(eps[ids["ematz"], 2]))
        self._mcoef = (self.grid, self.device, coeffs)
        return coeffs

    # ---------------- species / particles ----------------

    def define_species(self, name, q, m, max_local_np, max_local_nm=-1,
                       sort_interval=0, sort_out_of_place=1) -> SpeciesParams:
        p = SpeciesParams(name=name, q=float(q), m=float(m),
                          capacity=int(math.ceil(max_local_np)),
                          sort_interval=int(sort_interval),
                          id=len(self.species))
        self.species.append(_StagedSpecies(params=p))
        return p

    def inject_particle(self, sp: SpeciesParams, x, y, z, ux, uy, uz, w,
                        age=0.0, update_rhob=0):
        """Robust global -> (voxel, offset) conversion in double precision
        (misc.cc:16-100), staged on the host.  A particle with ``age`` != 0
        gets the partial push u * age * cvac * dt / gamma at initialize()
        (misc.cc:80-99)."""
        g = self.grid
        if w < 0:
            raise ValueError("inject_particle: w < 0")
        x0, y0, z0, x1, y1, z1 = g.x0, g.y0, g.z0, g.x1, g.y1, g.z1
        if not (x0 <= x <= x1 and y0 <= y <= y1 and z0 <= z <= z1):
            return
        nx, ny, nz = g.gnx, g.gny, g.gnz

        def conv(v, v0, v1, n):
            v = float(n) * ((v - v0) / (v1 - v0))
            iv = int(v)
            v -= iv
            v = (v + v) - 1.0
            if iv == n:
                v = 1.0
                iv = n - 1
            return v, iv + 1

        dx, ix = conv(x, x0, x1, nx)
        dy, iy = conv(y, y0, y1, ny)
        dz, iz = conv(z, z0, z1, nz)
        self.species[sp.id].xs.append(
            (dx, dy, dz, ix, iy, iz, ux, uy, uz, w, age, update_rhob))

    # ---------------- field loading ----------------

    def set_region_field(self, region, ex=0, ey=0, ez=0, bx=0, by=0, bz=0):
        """set_point_region_field (deck/wrapper.h:190-210): evaluate each
        component's expression at its Yee stagger position (over ghosts too)
        wherever ``region(x,y,z)`` holds.  B is stored internally as cB.
        Recorded here, materialized at initialize()."""
        self._field_ops.append((region, dict(ex=ex, ey=ey, ez=ez,
                                             bx=bx, by=by, bz=bz)))

    def _materialize_fields(self) -> dict:
        """Evaluate the recorded region-field ops on this rank's ghosted
        mesh; returns 6 float32 numpy arrays (ex, ey, ez, cbx, cby, cbz)."""
        g = self.grid
        c = g.cvac
        x0, y0, z0 = local_corner(g, flat_rank(g))
        xn = x0 + g.dx * (np.arange(g.NX) - 1.0)
        yn = y0 + g.dy * (np.arange(g.NY) - 1.0)
        zn = z0 + g.dz * (np.arange(g.NZ) - 1.0)
        xc, yc, zc = xn + 0.5 * g.dx, yn + 0.5 * g.dy, zn + 0.5 * g.dz

        out = {k: np.zeros(g.shape, np.float32)
               for k in ("ex", "ey", "ez", "cbx", "cby", "cbz")}
        # Yee stagger sample positions (wrapper.h:196-207).
        stagger = dict(ex=(xc, yn, zn), ey=(xn, yc, zn), ez=(xn, yn, zc),
                       cbx=(xn, yc, zc), cby=(xc, yn, zc), cbz=(xc, yc, zn))
        scales = dict(ex=1.0, ey=1.0, ez=1.0, cbx=c, cby=c, cbz=c)
        keymap = dict(ex="ex", ey="ey", ez="ez", bx="cbx", by="cby", bz="cbz")

        for region, exprs in self._field_ops:
            for ekey, expr in exprs.items():
                name = keymap[ekey]
                xs, ys, zs = stagger[name]
                Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
                if callable(expr):
                    vals = np.vectorize(expr, otypes=[np.float64])(X, Y, Z)
                else:
                    vals = np.full(X.shape, float(expr))
                if callable(region):
                    mask = np.vectorize(region, otypes=[bool])(X, Y, Z)
                else:
                    mask = np.full(X.shape, bool(region))
                out[name] = np.where(mask, scales[name] * vals,
                                     out[name]).astype(np.float32)
        return out

    # ---------------- initialize (initialize.cc:5-64) ----------------

    def _pack_species(self):
        """Host-pack the staged particles into fixed-capacity arrays, in
        injection order; on a decomposed grid the lanes of this rank's
        brick (global voxel -> local voxel, vpic_tpu/deck.py:696-775).
        Returns (species_states, update_rhob_masks, ages) on
        ``self.device``; a species' ages are None when none is staged with
        an age."""
        g = self.grid
        rank = flat_rank(g)
        out, urbs, ages = [], [], []
        for st in self.species:
            cap = st.params.capacity
            rows = (np.asarray(st.xs, np.float64) if st.xs
                    else np.zeros((0, 12)))
            if g.sharded:
                gijk = rows[:, 3:6].astype(np.int64) - 1
                s3 = gijk // np.array([g.nx, g.ny, g.nz])
                px, py, pz = g.topology
                rows = rows[(s3[:, 0] * py + s3[:, 1]) * pz + s3[:, 2]
                            == rank].copy()
                rows[:, 3:6] -= np.array(rank_coords(g, rank)) * \
                    np.array([g.nx, g.ny, g.nz])
            a = rows[:, :10]
            urb = rows[:, 11].astype(bool)
            n = len(a)
            if n > cap:
                raise RuntimeError(
                    f"species {st.params.name}: {n} particles overflow "
                    f"capacity {cap}" + (f" on rank {rank}" if g.sharded
                                         else ""))
            vox = (a[:, 3].astype(np.int64)
                   + g.NX * (a[:, 4].astype(np.int64)
                             + g.NY * a[:, 5].astype(np.int64))
                   ).astype(np.int32)
            cols = {}
            for name, col in (("dx", 0), ("dy", 1), ("dz", 2), ("ux", 6),
                              ("uy", 7), ("uz", 8), ("w", 9)):
                buf = np.zeros(cap, np.float32)
                buf[:n] = a[:, col]
                cols[name] = buf
            ibuf = np.zeros(cap, np.int32)
            ibuf[:n] = vox
            lbuf = np.zeros(cap, bool)
            lbuf[:n] = True
            ubuf = np.zeros(cap, bool)
            ubuf[:n] = urb
            abuf = np.zeros(cap, np.float32)
            abuf[:n] = rows[:, 10]
            t = lambda arr: torch.from_numpy(arr).to(self.device)
            out.append(SpeciesState(
                **{k: t(v) for k, v in cols.items()}, i=t(ibuf),
                live=t(lbuf),
                np=torch.tensor(n, dtype=torch.int32, device=self.device)))
            urbs.append(t(ubuf))
            ages.append(t(abuf) if abuf.any() else None)
        return tuple(out), tuple(urbs), tuple(ages)

    def _build_initial_fields(self) -> FieldState:
        """Materialize the recorded region-field ops into a FieldState."""
        f = FieldState.zeros(self.grid, self.device)
        for k, v in self._materialize_fields().items():
            getattr(f, k).copy_(torch.from_numpy(v))
        return f

    def _check_device(self):
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Simulation.device is 'cuda' (the default) but PyTorch sees "
                "no CUDA device; pass device='cpu' to run on the CPU")

    def initialize(self) -> SimState:
        """Post-deck derived-state fixups (initialize.cc:5-64), in the JAX
        package's order: rhob, the aged lanes' partial push, B cleaning,
        curl B, rho, rhob from div E, E cleaning, then u back half a
        step.  On a decomposed grid every rank makes the call (the field
        fixups exchange halos) and gets its own brick's state."""
        self._check_device()
        g = self.grid
        self._path()
        m = self._material_coeffs()
        f = self._build_initial_fields()
        species, urbs, ages = self._pack_species()

        rhob = f.rhob.reshape(-1)
        for st, sp, urb in zip(self.species, species, urbs):
            P.deposit_rhob(rhob, g, sp.i, sp.dx, sp.dy, sp.dz, sp.w,
                           -st.params.q, urb & sp.live)
        species = self._aged_push(species, ages, rhob)
        F.synchronize_tang_e_norm_b(f, g)
        F.compute_div_b_err(f, g)
        F.clean_div_b(f, g)
        F.compute_curl_b(f, g, m)
        F.clear_rhof(f)
        rhof = f.rhof.reshape(-1)
        for st, sp in zip(self.species, species):
            P.accumulate_rho_p(rhof, sp, g, st.params.q)
        F.synchronize_rho(f, g)
        F.compute_rhob(f, g, m)
        F.compute_div_e_err(f, g, m)
        F.clean_div_e(f, g, m)
        F.synchronize_tang_e_norm_b(f, g)
        fcoef = I.load_interpolator(f, g)
        species = tuple(
            P.uncenter_p(sp, fcoef, g, st.params.q, st.params.m)
            for st, sp in zip(self.species, species))
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self._generator_seed())
        # the JAX package's state key, drawn as its initialize() draws it
        # (jax.random.PRNGKey of a host draw, [0, seed] as uint32): the
        # port draws nothing from it, but carries it in SimState.rng so a
        # checkpoint the JAX package restores holds the key it would have
        # made for this deck
        rng = np.array([0, self._entropy.randint(0, 2**31 - 1)], np.uint32)
        return SimState(fields=f, species=species, step=0,
                        diag=self._initial_diag(), rng=rng)

    def _generator_seed(self) -> int:
        """The handlers' generator seed: ``seed``, with the rank folded in
        on a decomposed grid so the ranks draw apart (the JAX package's
        per-shard key, vpic_tpu/parallel/mesh.py:181-207)."""
        g = self.grid
        return self.seed + (flat_rank(g) << 32 if g.sharded else 0)

    def _aged_push(self, species, ages, rhob):
        """Aged injection (misc.cc:88-99), as vpic_tpu/deck.py:832-870:
        the lanes staged with age != 0 walk u * age * cvac * dt / gamma
        through move_p (reflecting faces bounce them, absorbing faces kill
        them with their charge into ``rhob``, in place); the walk's current
        deposits are dropped, as the first step's cleared accumulator
        drops the reference's."""
        g = self.grid
        out = []
        for st, sp, age in zip(self.species, species, ages):
            if age is not None:
                gam = torch.sqrt(1.0 + sp.ux * sp.ux + sp.uy * sp.uy
                                 + sp.uz * sp.uz)
                aged = age * (g.cvac * g.dt) / gam
                disp = (sp.ux * aged * g.rdx, sp.uy * aged * g.rdy,
                        sp.uz * aged * g.rdz)
                pend = torch.full((sp.capacity,), P.DONE, dtype=torch.int32,
                                  device=sp.dx.device)
                acc = torch.zeros((g.nv, 12), dtype=torch.float32,
                                  device=sp.dx.device)
                sp = MP.move_p(sp, pend, disp, acc, rhob, g, st.params.q,
                               sp.live & (age != 0.0), self.max_streak)[0]
            out.append(sp)
        return tuple(out)

    def _initial_diag(self) -> dict:
        """The step's diag entries as initialize() makes them: the
        unfinished-streak count, the handlers' counters and, on the 3-D
        kernel path, the home maps (with the residency flag and rebucket
        count).  The keys other than ``unfinished`` are the ones
        ``vpic_tpu``'s initialize() makes for the same deck."""
        g = self.grid
        path, _ = self._path()
        # lanes left walking after max_streak rounds, summed over steps
        i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                         device=self.device)
        diag = {"unfinished": i32()}
        # the handlers' counters, made once so the key set stays fixed
        sp_params = [st.params for st in self.species]
        for key, h in self.pbc_handlers.items():
            if hasattr(h, "diag_init"):
                diag.update(h.diag_init(sp_params, key, self.device))
        # the collision ops' large-pr tallies (vpic_tpu/deck.py:907-909)
        for op in self.collision_ops:
            if hasattr(op, "diag_init"):
                diag.update(op.diag_init(self.device))
        if path == "push3d":
            res_on, res_slack = self._residency_mode()
            if res_on:
                # residency works on [0, E) extent slices: the home maps
                # have E // 1024 blocks, and _res_valid False (a host bool)
                # makes the first step run the slack-padded brick sort
                for k, E in enumerate(RES.extents(
                        g, self._live_bounds(), res_slack)):
                    diag[f"_chart_home{k}"] = i32(E // FP3.BLOCK)
                diag["_res_valid"] = False
                diag["_res_rebuckets"] = i32()
            else:
                # the per-step brick sort writes the home maps before the
                # first push
                for k, st in enumerate(self.species):
                    diag[f"_chart_home{k}"] = i32(
                        -(-st.params.capacity // FP3.BLOCK))
        return diag

    # ---------------- the step (advance.cc:15-208) ----------------

    def _grows(self) -> bool:
        """True when something may put a live lane in a slot past the
        injection count: an emitter or either particle hook (the JAX
        package's ``not no_growth``, vpic_tpu/deck.py:1102-1121); on a
        decomposed grid migration appends arrivals."""
        return bool(self.emitters) or \
            self.user_particle_injection is not None or \
            self.user_particle_collisions is not None or \
            (self.grid is not None and self.grid.sharded)

    def _live_bounds(self):
        """Per-species bound on the live slots: the injection count, unless
        the deck ``_grows`` (then the capacity, and the sorts cover every
        slot).  Otherwise nothing grows the live set or moves a live lane
        past it: absorbing faces and the in-place handlers kill or move
        lanes in their slots, and the sorts and the collision ops' shuffle
        pack live lanes first, so sorts cover these extents only."""
        if self._grows():
            return [st.params.capacity for st in self.species]
        return [max(st.count, 1) for st in self.species]

    def _path(self):
        """(path, sortK), decided from the deck: "push3d" for nz > 1 grids
        the bricks tile (a brick sort every step, sortK 1, unless residency
        replaces it; vpic_tpu/deck.py:991-996), "push2d" for nz == 1 with a
        bucket sort every pallas_sort_interval steps (2-D brick charts,
        pallas_chart2d, are not ported), and "general" for the other 3-D
        grids (deck.py:1446-1496: sort_p on each species' sort_interval,
        the push of every species, boundary_p with its num_comm_round
        handler runs; the push is fused_push3d_multi without home maps,
        the 3-D kernel on the card).  Raises for what no path runs: remote
        faces, decomposed grids, and a handler that is not in place (none
        is ported)."""
        g = self.grid
        P.check_particle_bcs(g)
        for key, h in self.pbc_handlers.items():
            if not getattr(h, "in_place", False):
                raise NotImplementedError(
                    f"particle bc handler {key} is not in place: handlers "
                    "that move or create live slots are not ported yet")
        max_cap = max((st.params.capacity for st in self.species),
                      default=0)
        if g.nz > 1:
            if FP3.supports3d(g, max_cap):
                return "push3d", 1
            FP3.check3d(g, max_cap, bricks=False)
            return "general", 1
        FP.supports(g)
        return "push2d", max(1, self.pallas_sort_interval)

    def _residency_mode(self):
        """(enabled, slack): per-brick bucketed residency (ops/residency) on
        3-D kernel-path decks with capacity headroom for at least one slack
        block per brick (vpic_tpu's pallas_residency="auto",
        vpic_tpu/deck.py:1005-1051; its forced settings are not ported).
        The lane-reordering ops disable it: an emitter, either particle
        hook, and a collision op that fires every step.  A collision op
        whose interval is >= 2 (or <= 0: it never fires) keeps it, and the
        step rebuckets before the push on the steps it fires.  The kernel
        path takes only in-place handlers, and migration waits for
        decomposition."""
        g = self.grid
        if g is None or g.nz == 1 or g.sharded or \
                self._path()[0] != "push3d":
            return False, 0
        coll_ok = all(getattr(op, "interval", 0) >= 2
                      or getattr(op, "interval", 1) <= 0
                      for op in self.collision_ops)
        if self._grows() or not coll_ok:
            return False, 0
        slack = RES.slack_blocks(g, self._live_bounds(),
                                 [st.params.capacity for st in self.species])
        return (True, slack) if slack >= 1 else (False, 0)

    def make_advance(self) -> Callable[[SimState], SimState]:
        """The step: the collision ops and the user_particle_collisions hook
        (on the general path after its sort_p), the push of every species
        with its sort, the parked lanes' boundary handling, the emitters
        and the user_particle_injection hook (after the push's handlers on
        the kernel paths of one domain, before boundary_p on the general
        path and on a decomposed grid, as the JAX package runs them),
        accumulator unload, advance_b / advance_e /
        advance_b (with the user current and field injection hooks; the
        fused field_beb kernel where it covers the deck, see
        field_advance), then the cleaners on their cadence.  The step
        updates the state's tensors in place, on both devices, and returns
        a SimState that holds them: the fields (rhob keeps the absorbed
        charge across steps), the species (the push kernels write them,
        the residency merge writes into them, and a sort, a rebucket, a
        collision op's shuffle or a plain version's new tensors are copied
        into them) and the diag tensors (counts added in place), so every
        tensor a step carries to the next keeps its storage and the step
        can be captured as a CUDA graph (step_graph).  The accumulator is
        allocated here, once, and zeroed every step.

        Every operation of the step lies in one stage of
        utils.profile.STAGES, in the step's order: load_interpolator,
        sort_p (the 2-D bucket sort, the 3-D relayout or brick sort, the
        general path's sorts), collision, advance_p (the accumulator's
        zeroing, the push, the parked lanes' handlers, the emitters),
        residency_plan, residency_exchange (the rebucket or merge),
        unload_accumulator (with the current hook), field_advance,
        clean_div, carry (the copies into the state's tensors); on the
        2-D and residency paths the collision ops run before the sort.
        The step calls utils.profile.marks' marker as each stage starts:
        eagerly under a profiler a ``vpic.<stage>`` range, while captured
        the graph's stage map (step_graph._Capture.stage), else nothing;
        eagerly it also calls ``observe(stage)`` where that is set.

        "push2d" (nz == 1): a bucket sort every pallas_sort_interval steps
        and the 2-D push kernel (fused_push_multi).  "push3d": with
        residency, the brick sort runs once (and again on a rebucket) and
        each step pushes with the outbox epilogue, handles the parked
        lanes, plans the exchange and merges; without, every step
        brick-sorts and pushes (fused_push3d_multi).  "general" (3-D grids
        the bricks do not tile): sort_p on each species' sort_interval,
        fused_push3d_multi without home maps, boundary_p with its
        num_comm_round handler runs.  The returned function's ``path`` names
        the path, its ``fields`` the field advance (field_advance), its
        ``cadence(step, diag)`` the step's Cadence, and its ``capture``
        (None unless step_graph is capturing the step) takes the residency
        decision's two branches as conditional graph nodes."""
        self._check_device()
        g = self.grid
        path, sortK = self._path()
        res_on, res_slack = self._residency_mode()
        m = self._material_coeffs()
        sp_params = [st.params for st in self.species]
        qms = [(spp.q, spp.m) for spp in sp_params]
        sort_extents = self._live_bounds()
        if res_on:
            res_exts = RES.extents(g, sort_extents, res_slack)
            _, res_spid, res_usable = RES.static_layout(res_exts)
        max_streak = self.max_streak
        ce = self.clean_div_e_interval
        cb = self.clean_div_b_interval
        sy = self.sync_shared_interval
        u_current = self.user_current_injection
        trio, trio_label = self.field_advance()
        handlers = dict(self.pbc_handlers)
        vbc = self._local_vbc()
        walled = P.has_walls(g, vbc)
        # lanes can be parked at a custom face or leave for another rank:
        # boundary_p runs (on a decomposed grid with its migration rounds
        # on every path, vpic_tpu/deck.py:1328-1336, 1433-1440)
        parks = bool(handlers) or g.sharded or any(
            bc <= FIRST_CUSTOM_PBC for bc in g.particle_bc)
        mesh = mesh_of(g)
        collision_ops = tuple(self.collision_ops)
        u_collide = self.user_particle_collisions
        emitters = tuple(self.emitters)
        u_pinject = self.user_particle_injection
        for em in emitters:
            if hasattr(em, "prepare"):
                em.prepare(self.device, g)
        # the collision ops' cadences: the residency step rebuckets before
        # the push on the steps one of them fires
        fire_every = [getattr(op, "interval", 0) for op in collision_ops]
        acc0 = torch.zeros((g.nv, 12), dtype=torch.float32,
                           device=self.device)

        def cadence(step: int, diag) -> Cadence:
            fire = tuple(k > 0 and step % k == 0 for k in fire_every)
            return Cadence(
                sort=path == "push2d" and step % sortK == 0,
                sorts=tuple(path == "general" and spp.sort_interval > 0
                            and step % spp.sort_interval == 0
                            for spp in sp_params),
                fire=fire,
                relayout=res_on and (not diag["_res_valid"] or any(fire)),
                clean_e=ce > 0 and step % ce == 0,
                clean_b=cb > 0 and step % cb == 0,
                sync=sy > 0 and step % sy == 0)

        def generator():
            if self._generator is None:
                raise RuntimeError(
                    "the deck's collision ops, emitters and particle hooks "
                    "draw from the Simulation's generator, made at "
                    "initialize() (or restore)")
            return self._generator

        def collide(species, f, step, diag):
            """The collision ops, then the user hook (advance.cc:45-47)."""
            for op in collision_ops:
                if getattr(op, "has_diag", False):
                    species, d = op(species, f, g, step, generator(), diag)
                    diag.update(d)
                else:
                    species = op(species, f, g, step, generator())
            if u_collide is not None:
                species = u_collide(species, f, g, step, generator())
            return list(species)

        def emit(species, f, fcoef, acc, rhob, step, walls=None):
            """The emitters, then the injection hook (advance.cc:58-60);
            a new rhob they return goes into the state's.  Where boundary_p
            runs after them, ``walls`` is the push's: the pend codes of the
            slots dead now are set to DONE first, since new lanes go there
            and the push kernels leave a dead slot's code unwritten."""
            if not emitters and u_pinject is None:
                return list(species), acc
            if walls is not None:
                for sp, pend in zip(species, walls.pends):
                    pend.masked_fill_(~sp.live, P.DONE)
            out = rhob
            for em in emitters:
                species, acc, out = em(species, f, fcoef, acc, out, g, step,
                                       generator())
            if u_pinject is not None:
                species, acc, out = u_pinject(species, f, fcoef, acc, out, g,
                                              step, generator())
            if out is not rhob:
                rhob.copy_(out)
            return list(species), acc

        def clean_e(f, species, diag):
            F.clear_rhof(f)
            # the 3-D path's home maps let the deposit use brick tiles
            homes = ([diag[f"_chart_home{k}"] for k in range(len(species))]
                     if path == "push3d" else None)
            RHO.accumulate_rho_multi(f.rhof.reshape(-1), species,
                                     [spp.q for spp in sp_params], g, homes)
            F.synchronize_rho(f, g)
            for _ in range(self.num_div_e_round):
                F.compute_div_e_err(f, g, m)
                F.clean_div_e(f, g, m)

        def clean_b(f):
            for _ in range(self.num_div_b_round):
                F.compute_div_b_err(f, g)
                F.clean_div_b(f, g)

        def handle_parked(species, walls, acc, diag, rounds):
            """The parked lanes' handlers (boundary_p), in place."""
            if not parks:
                return species, acc
            species, acc, _, dropped, hd = B.boundary_p(
                species, sp_params, walls.pends, walls.disps, acc,
                walls.rhob, g, num_comm_round=rounds, max_streak=max_streak,
                custom_handlers=handlers, generator=self._generator,
                diag=diag, vbc=vbc, stats=self.migration)
            diag.update(hd)
            if g.sharded:
                self.migration["n_dropped"] = \
                    self.migration["n_dropped"] + dropped
            return species, acc

        def emit_and_park(species, f, fcoef, acc, rhob, step, walls, diag):
            """The kernel paths after the push: on one domain the parked
            lanes' handlers, then the emitters; on a decomposed grid the
            emitters, then boundary_p with its migration rounds
            (vpic_tpu/deck.py:1420-1440)."""
            if g.sharded:
                species, acc = emit(species, f, fcoef, acc, rhob, step,
                                    walls)
                return handle_parked(species, walls, acc, diag,
                                     self.num_comm_round)
            species, acc = handle_parked(species, walls, acc, diag, 0)
            return emit(species, f, fcoef, acc, rhob, step)

        def sort_general(species, cad):
            # --- sort (performance + collision partition) ---
            for k in range(len(species)):
                if cad.sorts[k]:
                    species[k] = P.sort_p(species[k])
            return species

        def push_general(species, step, f, fcoef, acc, diag, rhob, home,
                         cad, mark):
            # the 3-D kernel without home maps (its plain version, advance_p
            # per species, on the CPU)
            mark("advance_p")
            acc.zero_()
            walls = P.Walls(rhob, vbc) if walled else None
            species, acc, _, _, _, unfinished = FP3.fused_push3d_multi(
                species, fcoef, acc, g, qms, max_streak=max_streak,
                walls=walls)
            diag["unfinished"].add_(unfinished)
            species, acc = emit(species, f, fcoef, acc, rhob, step, walls)
            # --- boundary interaction (boundary_p x num_comm_round,
            #     advance.cc:73-101) ---
            return handle_parked(species, walls, acc, diag,
                                 self.num_comm_round)

        def push2(species, step, f, fcoef, acc, diag, rhob, home, cad,
                  mark):
            if cad.sort:
                # sorted into the state's tensors, which the kernel pushes
                mark("sort_p")
                species = [_keep_species(h, FP.bucket_sort_p(
                    sp, g, extent=sort_extents[k]))
                    for k, (h, sp) in enumerate(zip(home, species))]
            mark("advance_p")
            acc.zero_()
            walls = P.Walls(rhob, vbc) if walled else None
            species, acc, unfinished = FP.fused_push_multi(
                species, fcoef, acc, g, qms, max_streak=max_streak,
                walls=walls)
            diag["unfinished"].add_(unfinished)
            # the parked lanes' handlers run once, as after the JAX
            # package's outlier replay (pallas_push.py:1010-1017)
            return emit_and_park(species, f, fcoef, acc, rhob, step, walls,
                                 diag)

        def sort_res(species):
            out = [FP3.brick_sort_p_res(sp, g, extent=sort_extents[k],
                                        slack=res_slack)
                   for k, sp in enumerate(species)]
            return [o[0] for o in out], [o[1] for o in out]

        def push3(species, step, f, fcoef, acc, diag, rhob, home, cad,
                  mark):
            nsp = len(species)
            walls = P.Walls(rhob, vbc) if walled else None
            home_maps = [diag[f"_chart_home{k}"] for k in range(nsp)]
            if not res_on:
                # sorted into the state's tensors and home maps
                mark("sort_p")
                for k in range(nsp):
                    sp, hm = FP3.brick_sort_p_home(species[k], g,
                                                   extent=sort_extents[k])
                    species[k] = _keep_species(home[k], sp)
                    _keep(home_maps[k], hm)
                homes = home_maps
                mark("advance_p")
                acc.zero_()
                species, acc, _, _, _, unfinished = FP3.fused_push3d_multi(
                    species, fcoef, acc, g, qms, homes=homes,
                    max_streak=max_streak, walls=walls)
                diag["unfinished"].add_(unfinished)
                return emit_and_park(species, f, fcoef, acc, rhob, step,
                                     walls, diag)
            # residency (vpic_tpu/deck.py:1195-1233, 1364-1419): the whole
            # path runs on the [0, E) extent slices, and its result goes
            # into the state's (``home``), also on a step where the
            # collision ops shuffled the lanes into new tensors (their live
            # lanes stay a prefix of the extent)
            sp_full = home
            species = [RES.slice_species(sp, res_exts[k])
                       for k, sp in enumerate(species)]
            if cad.relayout:
                mark("sort_p")
                self.relayouts += 1
                species, homes = sort_res(species)
                for hm, h in zip(home_maps, homes):
                    _keep(hm, h)
            homes = home_maps
            mark("advance_p")
            acc.zero_()
            species, acc, emits, obx, ores, unfinished = \
                FP3.fused_push3d_multi(species, fcoef, acc, g, qms,
                                       homes=homes, max_streak=max_streak,
                                       residency=True, walls=walls)
            diag["unfinished"].add_(unfinished)
            # the parked lanes before the exchange, as the JAX package's
            # replay (deck.py:1340-1380); a lane a handler moves out of its
            # home brick is misplaced, and the step rebuckets
            species, acc = handle_parked(species, walls, acc, diag, 0)
            mark("residency_plan")
            pl = RES.plan(species, emits, obx, ores, homes, res_spid,
                          res_usable, g)
            # both branches write into the state's extent slices, np and
            # home maps, so they keep their storage from step to step
            dst = [RES.slice_species(sp, res_exts[k])
                   for k, sp in enumerate(sp_full)]

            def rebucket():
                # emitted lanes are still resident, so nothing is lost
                sorted_sp, new_homes = sort_res(species)
                for d, s, sF in zip(dst, sorted_sp, sp_full):
                    RES.copy_species(d, s)
                    _keep(sF.np, s.np)
                for hm, h in zip(home_maps, new_homes):
                    hm.copy_(h)
                diag["_res_rebuckets"].add_(1)

            def merge():
                out = RES.merge_p(species, emits, pl.compact, pl.starts_j,
                                  pl.a_j, dst)
                for o, sF in zip(out, sp_full):
                    _keep(sF.np, o.np)

            rebuild = pl.rebuild
            mark("residency_exchange")
            if advance.capture is None:
                # the step's one host read
                self.host_syncs += 1
                (rebucket if bool(rebuild) else merge)()
            else:
                # captured: each branch under a conditional node
                with advance.capture.branch(rebuild, "rebucket"):
                    rebucket()
                with advance.capture.branch(~rebuild, "merge"):
                    merge()
            diag["_res_valid"] = True
            return list(sp_full), acc

        push = dict(push2d=push2, push3d=push3, general=push_general)[path]

        def advance(state: SimState) -> SimState:
            mark = PF.marks(advance.capture, advance.observe)
            out = stages(state, mark)
            mark(None)
            return out

        def stages(state: SimState, mark) -> SimState:
            f = state.fields
            species = list(state.species)
            step = state.step
            cad = cadence(step, state.diag)
            mark("load_interpolator")
            fcoef = I.load_interpolator(f, g)
            diag = dict(state.diag)
            if path == "general" and any(cad.sorts):
                mark("sort_p")
                species = sort_general(species, cad)
            if collision_ops or u_collide is not None:
                mark("collision")
                species = collide(species, f, step, diag)
            if species:
                species, acc = push(
                    species, step, f, fcoef, acc0, diag, f.rhob.view(-1),
                    state.species, cad, mark)
            else:
                mark("advance_p")
                acc = acc0.zero_()
            mark("unload_accumulator")
            F.clear_jf(f)
            I.unload_accumulator(f, acc, g)
            F.synchronize_jf(f, g)
            if u_current is not None:
                f = u_current(f, step)

            mark("field_advance")
            f = trio(f, step)

            if cad.clean_e or cad.clean_b or cad.sync:
                mark("clean_div")
            if cad.clean_e:
                clean_e(f, species, diag)
            if cad.clean_b:
                clean_b(f)
            if cad.sync:
                F.synchronize_tang_e_norm_b(f, g)
            if mesh is not None:
                # the collectives' device reads (gloo-staged copies, the
                # migration counts) are the step's host syncs too
                self.host_syncs += mesh.host_syncs - self._mesh_syncs
                self._mesh_syncs = mesh.host_syncs
            # everything the step carries to the next, in the state's
            # tensors
            mark("carry")
            for h, sp in zip(state.species, species):
                _keep_species(h, sp)
            if f is not state.fields:
                for n in FIELD_NAMES:
                    _keep(getattr(state.fields, n), getattr(f, n))
            for k, v in state.diag.items():
                if isinstance(v, torch.Tensor):
                    diag[k] = _keep(v, diag[k])
            return SimState(fields=state.fields, species=state.species,
                            step=step + 1, diag=diag, rng=state.rng)

        advance.path = path
        advance.fields = trio_label
        advance.cadence = cadence
        advance.capture = None
        advance.observe = None
        return advance

    def field_advance(self):
        """The step's field advance as ``(trio, label)``: ``trio(f, step)``
        runs advance_b(1/2), advance_e and advance_b(1/2) on the fields in
        place and returns them.  Where ops/field_fuse covers the grid and
        material and the deck has no user_field_injection hook (it runs
        between advance_e and the second advance_b), that is the fused
        field_beb kernel (its plain version on CPU tensors) and ``label``
        is "field_beb"; else the three plain ops with the hook between
        them, and ``label`` is "plain: <why>" (every reason, "; " between
        them).  A choice made from the deck's features when the step is
        made, never a fallback on a failure: on the card a failed build or
        launch raises."""
        g = self.grid
        m = self._material_coeffs()
        damp = self.damp
        hook = self.user_field_injection
        why = [w for w in (
            "user_field_injection runs between advance_e and the second "
            "advance_b" if hook is not None else None,
            FF.refusal(g, m)) if w]
        if not why:
            beb = FF.make_beb(g, m, damp)
            return (lambda f, step: beb(f)), "field_beb"

        def plain(f, step):
            F.advance_b(f, g, 0.5)
            F.advance_e(f, g, m, damp)
            if hook is not None:
                f = hook(f, step)
            F.advance_b(f, g, 0.5)
            return f

        return plain, "plain: " + "; ".join(why)

    def make_step(self) -> Callable[[SimState], SimState]:
        """The full step, the JAX package's jitted step: on the card the
        step captured as CUDA graphs (step_graph.GraphedStep), unless
        step_graph.refusal names a reason, and then the eager step of
        make_advance.  Each rank's process runs it on its own brick (the
        JAX package lifts the same shard-local step with shard_map).  The
        returned function's ``graphed`` is True or "eager: <every
        reason>", beside its ``path`` and ``fields``."""
        advance = self.make_advance()
        why = SG.refusal(self)
        if why is None:
            return SG.GraphedStep(self, advance)
        advance.graphed = "eager: " + why
        return advance

    def make_multi_step(self, n_sub: int) -> Callable[[SimState], SimState]:
        """``n_sub`` steps of make_step() in one call, the JAX package's
        make_multi_step (vpic_tpu/deck.py:1563-1583, one dispatch of a
        lax.scan): n_sub graph replays in the order of the steps' cadences,
        with no kernel launched from Python and no device read once each
        cadence is captured, or the eager step n_sub times on a deck
        step_graph.refusal names.  Carries ``path``, ``fields`` and
        ``graphed``."""
        return SG.multi(self.make_step(), n_sub)

    def run(self, state: SimState = None, num_step: int = None,
            energies_file: str = None, checkpt_base: str = None,
            checkpt_interval: int = 0, quota_s: float = None,
            verbose: bool = True) -> SimState:
        """The main loop (deck/main.cc:121 `while(advance());`) with the
        diagnostics idioms of sample/harris:395-404: at every
        status_interval step the status line and the profile table and a
        line of ``energies_file`` (which gets its header and the start
        state's line first), a checkpoint ``{checkpt_base}.{step}`` every
        ``checkpt_interval`` steps, and a checkpoint tagged "quota" when
        the wall clock passes ``quota_s`` seconds, which ends the run.
        The steps run in chunks of make_multi_step, as the JAX package's
        run (vpic_tpu/deck.py:1585-1625): the gcd of status_interval and
        checkpt_interval (else min(num_step, 100)), so every diagnostic and
        checkpoint step ends a chunk; a start off the chunk grid (a
        restore) runs single steps up to it.  The diagnostics run between
        chunks, and the loop reads nothing from the device but at those
        steps.  The quota is checked after every chunk.  On a decomposed
        grid every rank runs the loop (the dumps and checkpoints are
        collective), rank 0 prints and writes the energies, and the quota
        is rank 0's clock, shared with the others after every chunk."""
        import time
        from . import checkpoint as CK
        from . import dump as DU
        from .utils.profile import Profile

        if state is None:
            state = self.initialize()
        n = num_step if num_step is not None else self.num_step
        intervals = [v for v in (self.status_interval, checkpt_interval)
                     if v]
        chunk = math.gcd(*intervals) if intervals else min(max(n, 1), 100)
        step_fn = self.make_step()
        many_fn = SG.multi(step_fn, chunk)
        prof = Profile()
        t0 = time.time()
        if energies_file:
            DU.dump_energies(self, state, energies_file, append=False)
        while state.step < n:
            k = state.step
            # align to the chunk grid (a restore may start between)
            todo = min(chunk - k % chunk, n - k)
            status = bool(self.status_interval) and \
                (k + todo) % self.status_interval == 0
            with prof.tic("advance", todo):
                state = many_fn(state) if todo == chunk else \
                    SG.multi(step_fn, todo)(state)
                # the table reports the device's time up to a status step
                if status and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            k = state.step
            if status:
                if verbose and flat_rank(self.grid) == 0:
                    print(f"Completed step {k} of {n}")
                    prof.update_profile()
                if energies_file:
                    with prof.tic("dump_energies"):
                        DU.dump_energies(self, state, energies_file)
            if checkpt_base and checkpt_interval and \
                    k % checkpt_interval == 0:
                with prof.tic("checkpt"):
                    CK.checkpt(state, checkpt_base, sim=self)
            if quota_s is not None and self._past(time.time() - t0 > quota_s):
                if checkpt_base:
                    CK.checkpt(state, checkpt_base, tag="quota", sim=self)
                break
        return state

    def _past(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (every rank ends the run at the
        same step)."""
        m = mesh_of(self.grid)
        if m is None:
            return flag
        f = torch.tensor([float(flag and m.rank == 0)])
        return bool(m.all_max(f).item() > 0)

    # ---------------- diagnostics ----------------

    def energies(self, state: SimState) -> torch.Tensor:
        """dump_energies columns (dump.cc:37-77), a float32 device tensor:
        [ex, ey, ez, bx, by, bz, KE_sp0, KE_sp1, ...]"""
        g = self.grid
        f = state.fields
        en_f = F.all_sum(F.energy_f(f, g, self._material_coeffs()), g)
        fcoef = I.load_interpolator(f, g)
        en_p = [F.all_sum(P.energy_p(sp, fcoef, g, st.params.q,
                                     st.params.m), g)
                for st, sp in zip(self.species, state.species)]
        return torch.cat([en_f, torch.stack(en_p)]) if en_p else en_f
