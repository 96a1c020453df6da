"""Harris-sheet magnetic reconnection deck (sample/harris re-designed as a
Python deck).  Physics setup follows Daughton, Phys. Plasmas 9, 3668 (2002):
a thin current sheet B = b0 tanh(x/L) z^ with drifting bi-species Harris
equilibrium + uniform background, periodic in y/z, reflecting pec walls in x.

This is the flagship benchmark deck: the BASELINE north-star metric
(pushes/s/chip) is measured on it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..deck import Simulation, everywhere
from ..grid import BOUNDARY, PEC, REFLECT_PARTICLES


@dataclass
class HarrisParams:
    mass_ratio: float = 1.0
    seed: int = 0
    rhoi_L: float = 1.0     # ion gyroradius / sheet thickness
    Ti_Te: float = 1.0
    wpe_wce: float = 3.0
    theta: float = 0.0
    taui: float = 100.0
    Lx: float = 16.0
    Ly: float = 16.0
    Lz: float = 16.0
    nx: int = 64
    ny: int = 64
    nz: int = 1
    nppc: float = 64.0      # total macro particles / cell (both species)
    cfl_req: float = 0.99
    wpedt_max: float = 0.36
    damp: float = 0.001
    topology: tuple = (1, 1, 1)
    sort_interval: int = 20
    headroom: float = 1.5   # particle buffer slack (harris:178-181)
    # Replicate the reference deck's EXACT particle load (sample/harris:
    # 253-286 under seed_entropy(seed), rng(0) = SFMT-11213 stream) so a
    # drift run is same-trajectory comparable to the reference built on
    # this host (ENERGY_AXIS.md).  ~45 s of host-side RNG at 64^2 x 64ppc.
    gold_load: bool = False


def build(p: HarrisParams = HarrisParams(), device="cuda") -> Simulation:
    """The harris deck on ``device`` (the card unless the caller asks for
    the CPU)."""
    sim = Simulation(seed=p.seed, device=device)
    sim.seed_entropy(p.seed)

    # --- units and derived physics (harris deck lines 66-126) ---
    L = 1.0
    ec, me, c, eps0 = 1.0, 1.0, 1.0, 1.0
    mi = me * p.mass_ratio
    kTe = me * c * c / (2 * p.wpe_wce ** 2 * (1 + p.Ti_Te))
    kTi = kTe * p.Ti_Te
    vthi = math.sqrt(2 * kTi / mi)
    wci = vthi / (p.rhoi_L * L)
    wce = wci * p.mass_ratio
    wpe = wce * p.wpe_wce
    vdre = c * c * wce / (wpe * wpe * L * (1 + p.Ti_Te))
    vdri = -p.Ti_Te * vdre
    b0 = me * wce / ec
    n0 = me * eps0 * wpe * wpe / (ec * ec)
    Npe = 2 * n0 * p.Ly * p.Lz * L * math.tanh(0.5 * p.Lx / L)
    Ne = 0.5 * p.nppc * p.nx * p.ny * p.nz
    Ni = Ne
    we = Npe / Ne
    wi = Npe / Ni
    gdri = 1 / math.sqrt(1 - vdri * vdri / (c * c))
    gdre = 1 / math.sqrt(1 - vdre * vdre / (c * c))
    udri = vdri * gdri
    udre = vdre * gdre
    uthi = math.sqrt(kTi / mi) / c
    uthe = math.sqrt(kTe / me) / c
    cs, sn = math.cos(p.theta), math.sin(p.theta)

    sim.define_units(c, eps0)
    dg = sim.courant_length(p.Lx, p.Ly, p.Lz, p.nx, p.ny, p.nz)
    dt = p.cfl_req * dg / c
    if wpe * dt > p.wpedt_max:
        dt = p.wpedt_max / wpe
    sim.define_timestep(dt)

    sim.num_step = int(0.2 * p.taui / (wci * dt))
    status = max(1, int(1.0 / (wci * dt)))
    sim.status_interval = status
    sim.sync_shared_interval = status
    sim.clean_div_e_interval = status
    sim.clean_div_b_interval = status

    sim.define_periodic_grid((-0.5 * p.Lx, 0, 0), (0.5 * p.Lx, p.Ly, p.Lz),
                             (p.nx, p.ny, p.nz), p.topology)
    # pec + reflecting walls at +-x (harris:158-163)
    sim.set_domain_field_bc(BOUNDARY(-1, 0, 0), PEC)
    sim.set_domain_field_bc(BOUNDARY(1, 0, 0), PEC)
    sim.set_domain_particle_bc(BOUNDARY(-1, 0, 0), REFLECT_PARTICLES)
    sim.set_domain_particle_bc(BOUNDARY(1, 0, 0), REFLECT_PARTICLES)

    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=p.damp)

    n_shards = p.topology[0] * p.topology[1] * p.topology[2]
    ion = sim.define_species("ion", ec, mi,
                             p.headroom * Ni / n_shards, -1,
                             2 * p.sort_interval, 1)
    electron = sim.define_species("electron", -ec, me,
                                  p.headroom * Ne / n_shards, -1,
                                  p.sort_interval, 1)

    # --- fields: B = b0 tanh(x/L) rotated by theta (harris:246-247) ---
    sim.set_region_field(everywhere, 0, 0, 0,
                         0,
                         lambda x, y, z: -sn * b0 * math.tanh(x / L),
                         lambda x, y, z: cs * b0 * math.tanh(x / L))

    # --- particles: Harris drifting maxwellian pairs (harris:253-286) ---
    if p.gold_load:
        # Bit-exact replication of the reference load loop: per pair, the
        # x rejection draw(s), y, z uniforms, then ion normals (ux,uy,uz),
        # then electron normals, consuming ONE shared rng(0) stream in the
        # reference's exact order (the weibel_gold.py technique).
        from ..utils.vpic_rng import entropy_rng
        r = entropy_rng(p.seed, 2, rank=0, world_size=1, index=0)
        for _ in range(int(Ni)):
            while True:
                x = L * math.atanh(r.uniform(-1.0, 1.0))
                if not (x <= -0.5 * p.Lx or x >= 0.5 * p.Lx):
                    break
            y = r.uniform(0.0, p.Ly)
            z = r.uniform(0.0, p.Lz)
            ux = r.normal(0.0, uthi)
            uy = r.normal(0.0, uthi)
            uz = r.normal(0.0, uthi)
            d0 = gdri * uy + math.sqrt(ux * ux + uy * uy + uz * uz + 1) \
                * udri
            uy, uz = d0 * cs - uz * sn, d0 * sn + uz * cs
            sim.inject_particle(ion, x, y, z, ux, uy, uz, wi)
            ux = r.normal(0.0, uthe)
            uy = r.normal(0.0, uthe)
            uz = r.normal(0.0, uthe)
            d0 = gdre * uy + math.sqrt(ux * ux + uy * uy + uz * uz + 1) \
                * udre
            uy, uz = d0 * cs - uz * sn, d0 * sn + uz * cs
            sim.inject_particle(electron, x, y, z, ux, uy, uz, we)
        sim.meta = dict(b0=b0, n0=n0, wci=wci, wce=wce, wpe=wpe, dt=dt,
                        kTi=kTi, kTe=kTe, Ne=Ne, Ni=Ni)
        return sim
    rng = sim.rng(0)
    # The reference injects Ni/nproc pairs per rank with rank-local domain
    # ownership (harris:253-286); staging here is global (the deck layer
    # bins per shard), so inject all Ni pairs once.
    n_inject = int(Ni)
    # vectorized staging (the reference loops one pair at a time)
    xs = np.empty(0)
    while xs.size < n_inject:
        cand = L * np.arctanh(rng.uniform(-1, 1, 2 * n_inject))
        cand = cand[(cand > -0.5 * p.Lx) & (cand < 0.5 * p.Lx)]
        xs = np.concatenate([xs, cand])[:n_inject]
    ys = rng.uniform(0, p.Ly, n_inject)
    zs = rng.uniform(0, p.Lz, n_inject)

    def boosted(uth, ud, gd):
        ux = rng.normal(0, uth, n_inject)
        uy = rng.normal(0, uth, n_inject)
        uz = rng.normal(0, uth, n_inject)
        d0 = gd * uy + np.sqrt(ux * ux + uy * uy + uz * uz + 1) * ud
        uy2 = d0 * cs - uz * sn
        uz2 = d0 * sn + uz * cs
        return ux, uy2, uz2

    iux, iuy, iuz = boosted(uthi, udri, gdri)
    eux, euy, euz = boosted(uthe, udre, gdre)
    for k in range(n_inject):
        sim.inject_particle(ion, xs[k], ys[k], zs[k],
                            iux[k], iuy[k], iuz[k], wi)
        sim.inject_particle(electron, xs[k], ys[k], zs[k],
                            eux[k], euy[k], euz[k], we)

    sim.meta = dict(b0=b0, n0=n0, wci=wci, wce=wce, wpe=wpe, dt=dt,
                    kTi=kTi, kTe=kTe, Ne=Ne, Ni=Ni)
    return sim
