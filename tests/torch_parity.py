"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
same harris deck built by both packages, states carried across as numpy,
and the tolerance checks the JAX package's own parity tests use."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import vpic_tpu.grid as GJ
import vpic_tpu.state as SJ
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.state as ST
from vpic_tpu.models import harris as harris_jax
from vpic_tpu_torch.interop import state_from_numpy, state_to_numpy
from vpic_tpu_torch.models import harris as harris_torch

# the small deck of tests/test_pallas.py
SMALL = dict(nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0)


def build_pair(**kw):
    """(vpic_tpu Simulation, vpic_tpu_torch Simulation) of one harris deck."""
    params = dict(SMALL, **kw)
    return (harris_jax.build(harris_jax.HarrisParams(**params)),
            harris_torch.build(harris_torch.HarrisParams(**params),
                               device="cpu"))


def to_torch(jax_state, device="cpu"):
    """A vpic_tpu SimState as the port's SimState."""
    return state_from_numpy(jax.device_get(jax_state), device=device)


def to_jax(torch_state):
    """The port's SimState as a vpic_tpu SimState (rng unset)."""
    host = state_to_numpy(torch_state)
    return SJ.SimState(
        fields=SJ.FieldState(**{n: jnp.asarray(a)
                                for n, a in host["fields"].items()}),
        species=tuple(SJ.SpeciesState(**{n: jnp.asarray(a)
                                         for n, a in sp.items()})
                      for sp in host["species"]),
        step=jnp.int32(host["step"]), rng=None, diag={})


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_close_rel(a, b, rel, abs_=0.0, what=""):
    """max|a - b| <= abs_ + rel * max|a| (a is the reference)."""
    a, b = np.asarray(np_(a), np.float64), np.asarray(np_(b), np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    bound = abs_ + rel * (np.abs(a).max() if a.size else 0.0)
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


# Field-op grids: (nx, ny, nz, field_bc per face -x,-y,-z,+x,+y,+z)
GRIDS = {
    # harris: pec walls in x, periodic y and z, 2-D
    "harris2d": (8, 6, 1, (GJ.PEC, GJ.PERIODIC, GJ.PERIODIC,
                           GJ.PEC, GJ.PERIODIC, GJ.PERIODIC)),
    # every other local rule: symmetric / pmc in y, absorbing in z
    "mixed3d": (5, 4, 3, (GJ.PERIODIC, GJ.SYMMETRIC, GJ.ABSORB_FIELDS,
                          GJ.PERIODIC, GJ.PMC, GJ.ABSORB_FIELDS)),
    "periodic3d": (4, 5, 3, (GJ.PERIODIC,) * 6),
}

# Walled grids of every face rule the fused field trio covers (pec,
# symmetric, pmc, periodic), for ops/field_fuse's tests.
WALL_GRIDS = {
    "pec3d": (5, 4, 3, (GJ.PEC, GJ.PERIODIC, GJ.PERIODIC,
                        GJ.PEC, GJ.PERIODIC, GJ.PERIODIC)),
    "walls3d": (4, 3, 5, (GJ.PERIODIC, GJ.SYMMETRIC, GJ.PEC,
                          GJ.PERIODIC, GJ.PMC, GJ.PEC)),
}

# a conducting, non-unit material: every coefficient enters the stencils
MAT = dict(decayx=0.91, decayy=0.93, decayz=0.95, drivex=0.97, drivey=0.96,
           drivez=0.94, rmux=0.8, rmuy=0.85, rmuz=0.9, nonconductive=1.0,
           epsx=1.2, epsy=1.1, epsz=1.3)


def field_pair(name, seed=0):
    """(grid, fields, material) in both packages: the same random fields."""
    nx, ny, nz, fbc = {**GRIDS, **WALL_GRIDS}[name]
    kw = dict(dt=0.05, cvac=1.0, eps0=1.0)
    gj = GJ.partition_periodic_box(0, 0, 0, 1.0, 0.8, 0.6, nx, ny, nz, **kw)
    gt = GT.partition_periodic_box(0, 0, 0, 1.0, 0.8, 0.6, nx, ny, nz, **kw)
    for face, bc in enumerate(fbc):
        gj = gj.with_bc(face, fbc=bc)
        gt = gt.with_bc(face, fbc=bc)
    rng = np.random.default_rng(seed)
    arrs = {n: rng.standard_normal(gj.shape).astype(np.float32)
            for n in ST.FIELD_NAMES}
    fj = SJ.FieldState(**{n: jnp.asarray(a) for n, a in arrs.items()})
    ft = ST.FieldState(**{n: torch.from_numpy(a.copy())
                          for n, a in arrs.items()})
    mj = SJ.MaterialCoeffs(**{k: jnp.float32(v) for k, v in MAT.items()})
    mt = ST.MaterialCoeffs(**{k: torch.tensor(v, dtype=torch.float32)
                              for k, v in MAT.items()})
    return (gj, fj, mj), (gt, ft, mt)


def _outputs(res):
    """Flatten an op's result (FieldState, tuple or array) into named
    float64 numpy arrays."""
    if isinstance(res, (SJ.FieldState, ST.FieldState)):
        return {n: np.asarray(np_(getattr(res, n)), np.float64)
                for n in ST.FIELD_NAMES}
    if isinstance(res, tuple):
        out = {}
        for k, r in enumerate(res):
            out.update({f"{k}.{n}": v for n, v in _outputs(r).items()})
        return out
    return {"value": np.asarray(np_(res), np.float64)}


def check_field_op(fn_jax, fn_torch, grid, rel=1e-6, seed=0):
    """Run fn(fields, grid, material) in both packages on the same random
    fields; every output must agree to rel * max|a|."""
    (gj, fj, mj), (gt, ft, mt) = field_pair(grid, seed)
    out_j = _outputs(fn_jax(fj, gj, mj))
    out_t = _outputs(fn_torch(ft, gt, mt))
    assert out_j.keys() == out_t.keys()
    for n in out_j:
        assert_close_rel(out_j[n], out_t[n], rel, 0.0, n)


def build3d_pair(walls=False, n_particles=5000, seed=0, capacity=24000):
    """(vpic_tpu Simulation, vpic_tpu_torch Simulation on the CPU) of the
    16^3 deck of tests/test_pallas3d.py: one electron species of
    ``n_particles`` warm particles (``capacity`` slots) in a periodic box
    with a standing wave.
    ``walls`` adds PEC field faces and reflecting particle faces at +-x
    (the port has no absorbing particle faces yet, so the z faces stay
    periodic)."""
    import vpic_tpu as vj
    import vpic_tpu_torch as vt
    sims = []
    for pkg, kw in ((vj, {}), (vt, {"device": "cpu"})):
        sim = pkg.Simulation(seed=5, **kw)
        sim.define_units(1.0, 1.0)
        n = 16
        g0 = pkg.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, n)
        sim.define_timestep(0.6 * g0.courant_length())
        sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, n))
        if walls:
            for side in (-1, 1):
                sim.set_domain_field_bc(pkg.BOUNDARY(side, 0, 0), pkg.PEC)
                sim.set_domain_particle_bc(pkg.BOUNDARY(side, 0, 0),
                                           pkg.REFLECT_PARTICLES)
        sim.define_material("vacuum", 1.0)
        sim.define_field_array(damp=0.0)
        el = sim.define_species("e", -1.0, 1.0, capacity, -1, 4, 1)
        rng = np.random.default_rng(seed)
        for _ in range(n_particles):
            sim.inject_particle(el, *rng.uniform(0.01, 0.99, 3),
                                *rng.normal(0, 0.4, 3), 1.0)
        sim.set_region_field(
            pkg.everywhere, ey=lambda x, y, z: 0.05 * np.cos(2 * np.pi * x),
            bz=lambda x, y, z: 0.05 * np.cos(2 * np.pi * x))
        sims.append(sim)
    sims[0].use_pallas = True
    return tuple(sims)
