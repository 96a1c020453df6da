"""Cygnus rod-pinch diode deck (counterpart of ``vpic_tpu/models/cygnus.py``;
the reference's sample/cygnus and its cygnus_close_up variant): a 2-D (x, z)
rod-pinch diode in rationalized MKSA units -- copper inner/outer
conductors, a tungsten anode rod and copper cathode plate as region
materials with fully absorbing particle surfaces (set_region_particle_bc),
a symmetric-field axis at x = 0, absorbing field faces in z, and a
trapezoidal voltage pulse driven through the field-injection hook across
the r_i..r_o feed gap.

Exercises the deck vocabulary the reference keeps for join_domain decks:
size_domain + set_domain_geometry + the join_domain self-join (periodic y
in 2-D) + BOUNDARY(i, j, k) face addressing.  Its grid (nx x 1 x nz) is
not tiled by the 8^3 bricks: it takes the general path; the absorbing
faces and the hook make its field advance the plain trio.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import deck as D
from ..grid import ABSORB_FIELDS, ABSORB_PARTICLES, BOUNDARY, SYMMETRIC


@dataclass
class CygnusParams:
    # geometry (m); reference cygnus:34-43
    emitter_to_cap: float = 2.5e-2
    cap_to_cathode: float = 10e-2
    cathode_width: float = 3e-3
    cathode_to_tip: float = 1e-2
    tip_to_absorber: float = 8e-3
    r_a: float = 0.375e-3
    r_c: float = 4.5625e-3
    r_i: float = 7e-2
    r_o: float = 19e-2
    # pulse (reference cygnus:63-67)
    V_peak: float = 1e6
    t_rise: float = 1e-9
    t_hold: float = 8e-9
    t_fall: float = 1e-9
    # resolution (reference runs 760 x 1 x 72; test scale by default)
    nx: int = 190
    nz: int = 18
    t_end: float = 10e-9
    close_up: bool = False   # cygnus_close_up: zoom on the diode gap
    seed: int = 11


def build(p: CygnusParams = CygnusParams(), device="cuda") -> D.Simulation:
    """The cygnus deck on ``device`` (the card unless the caller asks for
    the CPU)."""
    cvac = 299792458.0
    eps0 = 8.854187817e-12

    z_l = -p.emitter_to_cap
    z_i = z_l + p.emitter_to_cap
    z_al = z_i + p.r_i
    z_cl = z_al + p.cap_to_cathode
    z_ch = z_cl + p.cathode_width
    z_ah = z_ch + p.cathode_to_tip
    z_h = z_ah + p.tip_to_absorber
    if p.close_up:
        z_l = z_cl - 2e-2
        z_h = z_ah + p.tip_to_absorber

    r_i, r_o, r_a, r_c = p.r_i, p.r_o, p.r_a, p.r_c

    def inner_conductor(x, y, z):
        return z < z_i and (x * x + y * y) <= r_i * r_i

    def inner_cap(x, y, z):
        return z >= z_i and (x * x + y * y + (z - z_i) ** 2) <= r_i * r_i

    def anode(x, y, z):
        return z_al <= z <= z_ah and (x * x + y * y) <= r_a * r_a

    def cathode(x, y, z):
        return z_cl <= z <= z_ch and (x * x + y * y) >= r_c * r_c

    def outer_conductor(x, y, z):
        return (x * x + y * y) >= r_o * r_o

    nx, ny, nz = p.nx, 1, p.nz
    sim = D.Simulation(seed=p.seed, device=device)
    sim.define_units(cvac, eps0)
    # courant over the real spacings set below
    dx = r_o / nx
    dz = (z_h - z_l) / nz
    dt = 0.98 / (cvac * np.hypot(1.0 / dx, 1.0 / dz))
    sim.define_timestep(dt)

    sim.size_domain(nx, ny, nz)            # particle reflecting metal box
    sim.set_domain_geometry(x0=0.0, y0=-0.5e-6, z0=z_l,
                            dx=dx, dy=1e-6, dz=dz)
    sim.set_domain_field_bc(BOUNDARY(-1, 0, 0), SYMMETRIC)
    # 2-D: periodic along y via self-joins (cygnus:96-97)
    sim.join_domain(BOUNDARY(0, -1, 0), 0)
    sim.join_domain(BOUNDARY(0, 1, 0), 0)
    sim.set_domain_field_bc(BOUNDARY(0, 0, -1), ABSORB_FIELDS)
    sim.set_domain_field_bc(BOUNDARY(0, 0, 1), ABSORB_FIELDS)

    sim.define_material("vacuum", 1.0)
    copper = sim.define_material("copper", 1.0, 1.0, 5.98e7)
    tungsten = sim.define_material("tungsten", 1.0, 1.0, 1.85e7)
    sim.define_field_array(damp=0.005)

    sim.define_species("e-", -1.602176462e-19 / 9.10938188e-31, 1.0,
                       3 * nx * nx // 2)
    sim.define_species("H+", 1.602176462e-19 / 1.67262158e-27, 1.0,
                       3 * nz * nx // 2)

    for region, mat in ((inner_conductor, copper), (inner_cap, copper),
                        (anode, tungsten), (cathode, copper),
                        (outer_conductor, copper)):
        sim.set_region_material(region, mat, mat)
        sim.set_region_particle_bc(region, ABSORB_PARTICLES)

    sim.num_step = int(p.t_end / dt)
    sim.status_interval = 25
    sim.clean_div_e_interval = 25
    sim.clean_div_b_interval = 25
    sim.sync_shared_interval = 25

    # trapezoidal voltage pulse across the feed gap (cygnus:140-165), in
    # float32 as the JAX deck computes it
    g = sim.grid
    xs = g.x0 + g.dx * (np.arange(g.NX) - 0.5)
    feed = torch.from_numpy(((xs >= r_i) & (xs <= r_o)).astype(np.float32))
    on_device = {}
    f32 = np.float32
    tr, tf = p.t_rise, p.t_rise + p.t_hold
    te = tf + p.t_fall
    Vp = p.V_peak

    def field_injection(f, step):
        t = f32(g.dt) * f32(step)
        if t < f32(tr):
            V = f32(Vp) * t / f32(tr)
        elif t < f32(tf):
            V = f32(Vp)
        elif t < f32(te):
            V = f32(Vp) * (f32(te) - t) / f32(te - tf)
        else:
            V = f32(0.0)
        ex_inj = -V / f32(r_o - r_i)
        dev = f.ex.device
        if dev not in on_device:
            on_device[dev] = feed.to(dev)
        # rows y = 1, 2 of the z = 1 plane, in place
        f.ex[1, 1:3, :] += on_device[dev] * float(ex_inj)
        return f

    sim.user_field_injection = field_injection
    return sim
