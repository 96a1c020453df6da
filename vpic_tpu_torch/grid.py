"""Grid, units and boundary-condition metadata (counterpart of
``vpic_tpu/grid.py``, which it copies; framework-free).

This is the analogue of the reference's ``grid_t`` (src/grid/grid.h:73-131) and
its partitioners (src/grid/partition.c):

* The grid is a *static*, hashable dataclass.  Everything that the reference
  stores as runtime struct members that never change during a run (extents,
  strides, boundary conditions, decomposition topology) lives here and is
  read by the step functions as plain Python values.
* The reference's per-voxel ``neighbor[6*nv]`` table (grid.h:116-121) is
  replaced by arithmetic neighbor logic + a 6-entry per-face BC code.
* ``topology`` describes a domain decomposition: one process per rank
  (``parallel/mesh.py``), each holding one brick.  A rank's faces follow
  from its coordinates and the partner tables: ``rank_field_bc`` and
  ``rank_particle_bc`` give the codes the rank's field ops and push apply
  (REMOTE where a neighbouring rank owns the face).

Voxel indexing matches VPIC's FORTRAN-style convention
(``VOXEL(x,y,z) = x + (nx+2)*(y + (ny+2)*z)``, grid.h:136): arrays are stored
``[z, y, x]`` C-order so a C-order flatten gives exactly that linear index and
x is the unit-stride direction.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Boundary condition codes (grid.h:18-31 analogues + distributed codes)
# ---------------------------------------------------------------------------

# Field BCs on domain faces.
PERIODIC = 0          # wrap locally (axis not sharded) -- join_grid analogue
REMOTE = 1            # face owned by a neighboring shard (halo over ICI)
ANTI_SYMMETRIC = -1   # pec / metal: E_tang = 0
PEC = ANTI_SYMMETRIC
METAL = ANTI_SYMMETRIC
SYMMETRIC = -2        # B_tang = 0, B_norm = 0
PMC = -3              # B_tang = 0, B_norm floats
ABSORB_FIELDS = -4    # 1st-order Higdon ABC

# Particle BCs on domain faces.
P_PERIODIC = 0
P_REMOTE = 1
REFLECT_PARTICLES = -1
ABSORB_PARTICLES = -2
# ids <= -3 refer to custom particle BCs (maxwellian_reflux, absorb_tally...)
FIRST_CUSTOM_PBC = -3

# Face index convention: 0:-x 1:-y 2:-z 3:+x 4:+y 5:+z
# (matches move_p's ``face = axis; if (dir>0) face += 3``, move_p.cc:324)
FACE_AXIS = (0, 1, 2, 0, 1, 2)
FACE_SIDE = (-1, -1, -1, 1, 1, 1)


def boundary(i: int, j: int, k: int) -> int:
    """Map a (-1:1)^3 port coordinate to a face index (only the 6 axial ports
    are meaningful here; the reference's 27-point BOUNDARY(i,j,k) stencil
    collapses to 6 faces because VPIC only ever uses axial ports)."""
    if (i, j, k) == (-1, 0, 0):
        return 0
    if (i, j, k) == (0, -1, 0):
        return 1
    if (i, j, k) == (0, 0, -1):
        return 2
    if (i, j, k) == (1, 0, 0):
        return 3
    if (i, j, k) == (0, 1, 0):
        return 4
    if (i, j, k) == (0, 0, 1):
        return 5
    raise ValueError(f"not an axial port: {(i, j, k)}")


BOUNDARY = boundary  # deck-compat alias (deck/wrapper.h exposes BOUNDARY(i,j,k))


@dataclass(frozen=True)
class Grid:
    """Static per-shard grid description.

    ``nx, ny, nz`` are the *local* interior voxel counts of one shard.  The
    global domain is ``topology * (nx, ny, nz)`` voxels.  ``x0...z1`` are the
    *global* domain corners; local corners are derived per shard.
    """

    nx: int
    ny: int
    nz: int
    dt: float = 0.0
    cvac: float = 1.0
    eps0: float = 1.0

    # Global domain corners.
    x0: float = 0.0
    y0: float = 0.0
    z0: float = 0.0
    x1: float = 1.0
    y1: float = 1.0
    z1: float = 1.0

    # Device-mesh decomposition (px, py, pz).
    topology: Tuple[int, int, int] = (1, 1, 1)
    mesh_axes: Tuple[str, str, str] = ("px", "py", "pz")

    # Per-face boundary conditions, face order (-x,-y,-z,+x,+y,+z).
    field_bc: Tuple[int, int, int, int, int, int] = (PERIODIC,) * 6
    particle_bc: Tuple[int, int, int, int, int, int] = (P_PERIODIC,) * 6

    # Irregular domain graph (join_grid across arbitrary ranks,
    # grid/ops.c:119-212): 6 per-face partner tables, each a length-
    # n_shards tuple mapping flat rank -> joined partner rank (-1 = the
    # face keeps its local BC).  None = connectivity implied by the
    # cartesian ``topology``.  When set, halo exchange and particle
    # migration ride explicit flat-rank ppermute pairs instead of
    # whole-axis shifts, and a rank's face is remote iff its table entry
    # is >= 0 (replacing the edge-shard tests).  Joins connect OPPOSITE
    # faces (-x to a +x), like the reference's port ordering.
    face_partners: Optional[Tuple[Tuple[int, ...], ...]] = None

    t0: float = 0.0

    # ----- derived conveniences (grid.h:90-96) -----
    @property
    def gnx(self) -> int:
        return self.nx * self.topology[0]

    @property
    def gny(self) -> int:
        return self.ny * self.topology[1]

    @property
    def gnz(self) -> int:
        return self.nz * self.topology[2]

    @property
    def dx(self) -> float:
        return (self.x1 - self.x0) / self.gnx

    @property
    def dy(self) -> float:
        return (self.y1 - self.y0) / self.gny

    @property
    def dz(self) -> float:
        return (self.z1 - self.z0) / self.gnz

    @property
    def dV(self) -> float:
        return self.dx * self.dy * self.dz

    @property
    def rdx(self) -> float:
        return 1.0 / self.dx

    @property
    def rdy(self) -> float:
        return 1.0 / self.dy

    @property
    def rdz(self) -> float:
        return 1.0 / self.dz

    @property
    def r8V(self) -> float:
        return 0.125 / self.dV

    # Ghosted array extents.
    @property
    def NX(self) -> int:
        return self.nx + 2

    @property
    def NY(self) -> int:
        return self.ny + 2

    @property
    def NZ(self) -> int:
        return self.nz + 2

    @property
    def nv(self) -> int:
        return self.NX * self.NY * self.NZ

    @property
    def sy(self) -> int:
        """Linear-index stride of +1 voxel in y."""
        return self.NX

    @property
    def sz(self) -> int:
        """Linear-index stride of +1 voxel in z."""
        return self.NX * self.NY

    @property
    def shape(self) -> Tuple[int, int, int]:
        """Ghosted field-array shape, [z, y, x]."""
        return (self.NZ, self.NY, self.NX)

    @property
    def n_shards(self) -> int:
        px, py, pz = self.topology
        return px * py * pz

    @property
    def sharded(self) -> bool:
        return self.n_shards > 1

    # ----- indexing -----
    def voxel(self, x, y, z):
        """VOXEL(x,y,z) (grid.h:136): linear index into C-order [z,y,x]."""
        return x + self.NX * (y + self.NY * z)

    def decode_voxel(self, i):
        z, r = divmod(i, self.sz)
        y, x = divmod(r, self.sy)
        return x, y, z

    # ----- per-axis bc helpers -----
    def axis_bc(self, axis: int, side: int, particles: bool = False) -> int:
        face = axis + (3 if side > 0 else 0)
        return (self.particle_bc if particles else self.field_bc)[face]

    def with_bc(self, face: int, fbc: Optional[int] = None,
                pbc: Optional[int] = None) -> "Grid":
        fb = list(self.field_bc)
        pb = list(self.particle_bc)
        if fbc is not None:
            fb[face] = fbc
        if pbc is not None:
            pb[face] = pbc
        return dataclasses.replace(self, field_bc=tuple(fb),
                                   particle_bc=tuple(pb))

    def courant_length(self) -> float:
        """courant_length analogue (deck/wrapper.h): 1/sqrt(sum rdi^2) over
        non-degenerate axes."""
        s = 0.0
        if self.gnx > 1:
            s += self.rdx ** 2
        if self.gny > 1:
            s += self.rdy ** 2
        if self.gnz > 1:
            s += self.rdz ** 2
        return s ** -0.5


def flat_rank(g: Grid) -> int:
    """This process's flat rank (x-major, z-minor -- the dump/_shard_iter
    order): 0 on an undecomposed grid, else the current mesh's rank."""
    from .parallel.mesh import rank_of
    return rank_of(g)


def rank_coords(g: Grid, rank: int) -> Tuple[int, int, int]:
    """(ix, iy, iz) of flat rank ``rank``, x-major and z-minor."""
    px, py, pz = g.topology
    return rank // (py * pz), (rank // pz) % py, rank % pz


@functools.lru_cache(maxsize=256)
def halo_partners(g: Grid) -> Tuple[Tuple[int, ...], ...]:
    """Per face, flat rank -> the rank whose opposite face it exchanges
    with (-1: none): the join tables where the grid has them, else the
    cyclic neighbour along every decomposed axis, as the JAX package's
    whole-axis ppermutes wrap (a rank on the edge of a non-periodic axis
    receives its wrap neighbour's plane and keeps its own rule)."""
    if g.face_partners is not None:
        return g.face_partners
    px, py, pz = g.topology
    n = px * py * pz
    tabs = [[-1] * n for _ in range(6)]
    for r in range(n):
        co = list(rank_coords(g, r))
        for ax, nax in enumerate((px, py, pz)):
            if nax == 1:
                continue
            for side, face in ((-1, ax), (1, ax + 3)):
                nb = co.copy()
                nb[ax] = (co[ax] + side) % nax
                tabs[face][r] = (nb[0] * py + nb[1]) * pz + nb[2]
    return tuple(tuple(t) for t in tabs)


def _on_edge(g: Grid, face: int, rank: int) -> bool:
    """True when ``rank``'s face ``face`` applies the face's own rule: it
    has no partner in the join tables, or (cartesian) it lies on the
    global domain's face or the axis is not decomposed."""
    if g.face_partners is not None:
        return g.face_partners[face][rank] < 0
    ax = FACE_AXIS[face]
    if g.topology[ax] == 1:
        return True
    c = rank_coords(g, rank)[ax]
    return c == (0 if FACE_SIDE[face] < 0 else g.topology[ax] - 1)


@functools.lru_cache(maxsize=256)
def rank_field_bc(g: Grid, rank: int) -> Tuple[int, ...]:
    """The field BC code of each of ``rank``'s faces: REMOTE where the face
    takes a neighbour's planes, else the face's own rule (an unjoined face
    of a REMOTE axis wraps locally: PERIODIC), as vpic_tpu/ops/fields.py
    _ghost_value picks per shard."""
    out = []
    for face, bc in enumerate(g.field_bc):
        if g.face_partners is not None:
            out.append(REMOTE if not _on_edge(g, face, rank)
                       else (PERIODIC if bc == REMOTE else bc))
        elif g.topology[FACE_AXIS[face]] == 1 or bc == REMOTE:
            out.append(bc)
        else:
            out.append(bc if _on_edge(g, face, rank) else REMOTE)
    return tuple(out)


@functools.lru_cache(maxsize=256)
def rank_particle_bc(g: Grid, rank: int) -> Tuple[int, ...]:
    """The particle BC code of each of ``rank``'s faces: P_REMOTE where a
    lane leaving through it migrates to a neighbour (an interior face of a
    decomposed axis, a joined face, or a face whose code is P_REMOTE),
    else the face's own rule -- vpic_tpu/ops/push.py:505-553 and
    pallas_push.py _eff_bc."""
    out = []
    for face, bc in enumerate(g.particle_bc):
        ax = FACE_AXIS[face]
        joined = g.face_partners is not None and \
            any(v >= 0 for v in g.face_partners[face])
        if (g.topology[ax] > 1 or joined) and bc != P_REMOTE:
            out.append(bc if _on_edge(g, face, rank) else P_REMOTE)
        else:
            out.append(bc)
    return tuple(out)


def local_corner(g: Grid, rank: int) -> Tuple[float, float, float]:
    """The global coordinates of ``rank``'s brick corner (x0, y0, z0)."""
    sx, sy, sz = rank_coords(g, rank)
    return (g.x0 + sx * g.nx * g.dx, g.y0 + sy * g.ny * g.dy,
            g.z0 + sz * g.nz * g.dz)


def cartesian_partners(g: Grid) -> Tuple[Tuple[int, ...], ...]:
    """The per-face partner tables implied by the cartesian topology:
    interior shard faces link to the adjacent shard; global-edge faces
    wrap iff the axis is fully periodic (sharded periodic axes carry
    bc REMOTE); unsharded axes keep local wrap (no partner).  The seed
    table that join_domain overlays irregular joins onto."""
    px, py, pz = g.topology
    n = px * py * pz
    tabs = [[-1] * n for _ in range(6)]

    def rid(ix, iy, iz):
        return (ix * py + iy) * pz + iz

    for ix in range(px):
        for iy in range(py):
            for iz in range(pz):
                r = rid(ix, iy, iz)
                co = [ix, iy, iz]
                for ax, nax in enumerate((px, py, pz)):
                    if nax == 1:
                        continue
                    wrap = g.axis_bc(ax, -1) == REMOTE \
                        and g.axis_bc(ax, 1) == REMOTE
                    i = co[ax]
                    if i > 0 or wrap:
                        lo = co.copy()
                        lo[ax] = (i - 1) % nax
                        tabs[ax][r] = rid(*lo)
                    if i < nax - 1 or wrap:
                        hi = co.copy()
                        hi[ax] = (i + 1) % nax
                        tabs[ax + 3][r] = rid(*hi)
    return tuple(tuple(t) for t in tabs)


def partition_periodic_box(gx0, gy0, gz0, gx1, gy1, gz1,
                           gnx, gny, gnz, gpx=1, gpy=1, gpz=1,
                           dt=0.0, cvac=1.0, eps0=1.0) -> Grid:
    """partition_periodic_box analogue (src/grid/partition.c:35-89).

    Returns the static per-shard Grid; every shard has the same local brick
    (requires gn % gp == 0, like partition.c:51).
    """
    for gn, gp, name in ((gnx, gpx, "x"), (gny, gpy, "y"), (gnz, gpz, "z")):
        if gn % gp:
            raise ValueError(f"gn{name} ({gn}) not divisible by topology ({gp})")
    bc = []
    for axis, gp in enumerate((gpx, gpy, gpz)):
        bc.append(PERIODIC if gp == 1 else REMOTE)
    bc = tuple(bc) * 2
    pbc = []
    for axis, gp in enumerate((gpx, gpy, gpz)):
        pbc.append(P_PERIODIC if gp == 1 else P_REMOTE)
    pbc = tuple(pbc) * 2
    return Grid(nx=gnx // gpx, ny=gny // gpy, nz=gnz // gpz,
                dt=dt, cvac=cvac, eps0=eps0,
                x0=gx0, y0=gy0, z0=gz0, x1=gx1, y1=gy1, z1=gz1,
                topology=(gpx, gpy, gpz), field_bc=bc, particle_bc=pbc)


def partition_absorbing_box(gx0, gy0, gz0, gx1, gy1, gz1,
                            gnx, gny, gnz, gpx=1, gpy=1, gpz=1,
                            pbc=ABSORB_PARTICLES, **kw) -> Grid:
    """partition_absorbing_box analogue (partition.c:96-147)."""
    g = partition_periodic_box(gx0, gy0, gz0, gx1, gy1, gz1,
                               gnx, gny, gnz, gpx, gpy, gpz, **kw)
    for face in range(6):
        axis = FACE_AXIS[face]
        gp = (gpx, gpy, gpz)[axis]
        side = FACE_SIDE[face]
        # Only outermost shards get the absorbing faces; with gp>1 the
        # inner faces stay REMOTE and shard-edge handling applies the local
        # BC only on the outermost shard (see ops/fields._ghost_value).
        g = g.with_bc(face, fbc=ABSORB_FIELDS, pbc=pbc)
    return g


def partition_metal_box(gx0, gy0, gz0, gx1, gy1, gz1,
                        gnx, gny, gnz, gpx=1, gpy=1, gpz=1, **kw) -> Grid:
    """partition_metal_box analogue (partition.c:153-192)."""
    g = partition_periodic_box(gx0, gy0, gz0, gx1, gy1, gz1,
                               gnx, gny, gnz, gpx, gpy, gpz, **kw)
    for face in range(6):
        g = g.with_bc(face, fbc=PEC, pbc=REFLECT_PARTICLES)
    return g
