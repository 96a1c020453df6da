"""The port's emitters and device-side injection (vpic_tpu_torch/emitter.py)
against vpic_tpu/emitter.py on the CPU.

The region scans equal the JAX package's arrays bit for bit.
child_langmuir's apply, fed the variates jax.random makes from the JAX
op's keys (vpic_tpu/emitter.py:155-156), against the JAX op on the emission
deck's state (with holes in the live prefix, and with too few free slots):
live masks, voxels and weights equal, offsets and momenta to atol 3e-5
(tests/test_pallas.py:65-70), rhob to 1e-5 max|rhob| and acc to 1e-5
max|acc| (:71-72).  The free-slot pick equals jnp.nonzero(~live, size=M,
fill_value=capacity).  runtime_inject against the JAX op to the same
tolerances, and against the host's float64 staging on an 8192-cell axis
(tests/test_inject_reconnection.py:67-122): voxels equal, offsets within
3e-5 (they are equal: the port converts in float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu as vj
import vpic_tpu.emitter as EJ
import vpic_tpu.ops.interp as IJ
import vpic_tpu.state as SJ
import vpic_tpu_torch as vt
import vpic_tpu_torch.emitter as ET
import vpic_tpu_torch.ops.interp as IT
import vpic_tpu_torch.state as ST
from vpic_tpu.models import emission as emission_jax
from vpic_tpu_torch.models import emission

from torch_parity import assert_close_rel, np_

torch.set_num_threads(2)

LANE_FIELDS = ("dx", "dy", "dz", "ux", "uy", "uz")


def region3d(pkg, **kw):
    sim = pkg.Simulation(**kw)
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (6, 5, 4))
    return sim.grid


def sphere(x, y, z):
    return (x - 0.5) ** 2 + (y - 0.4) ** 2 + (z - 0.5) ** 2 < 0.12


def cathode(x, y, z):
    """The emission deck's region (models/emission.py)."""
    return x > 1.5 * (1.0 / 32)


@pytest.mark.parametrize("case", ["emission", "sphere3d"])
@pytest.mark.parametrize("kind", ["surface", "volume"])
def test_components_equal_jax(case, kind):
    if case == "emission":
        gj = emission_jax.build(emission_jax.EmissionParams()).grid
        gt = emission.build(emission.EmissionParams(), device="cpu").grid
        region = cathode
    else:
        gj, gt = region3d(vj), region3d(vt, device="cpu")
        region = sphere
    fj = getattr(EJ, f"{kind}_components")
    ft = getattr(ET, f"{kind}_components")
    (vj_, fj_), (vt_, ft_) = fj(gj, region), ft(gt, region)
    assert vj_.dtype == vt_.dtype == np.int32 and len(vt_) > 0
    assert np.array_equal(vj_, vt_) and np.array_equal(fj_, ft_)


def test_sharded_components_raise():
    """A decomposed grid's scan is the packed (vox, face, valid) triple
    (tests/test_torch_emitter_sharded.py holds it against vpic_tpu's); an
    emitter made from it raises when prepared for a grid of another
    topology."""
    sim = vt.Simulation(device="cpu")
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (8, 4, 4), (2, 1, 1))
    comps = ET.surface_components(sim.grid, sphere)
    assert len(comps) == 3 and comps[0].shape[:3] == (2, 1, 1)
    op = ET.child_langmuir(0, None, comps)
    with pytest.raises(ValueError, match="topology"):
        op.prepare("cpu", region3d(vt, device="cpu"))


@pytest.mark.parametrize("m", [1, 7, 40, 64])
def test_free_slots_equal_jax_nonzero(m):
    rng = np.random.default_rng(m)
    live = rng.uniform(size=64) < 0.7
    want = np.asarray(jnp.nonzero(jnp.asarray(~live), size=m,
                                  fill_value=64)[0])
    assert np.array_equal(ET.free_slots(torch.from_numpy(live), m).numpy(),
                          want)


def _species_pair(cap, n_live, g, seed):
    """The same species in both packages: ``n_live`` live lanes at random
    slots (holes in the prefix) of interior voxels."""
    rng = np.random.default_rng(seed)
    live = np.zeros(cap, bool)
    live[rng.choice(cap, n_live, replace=False)] = True
    vox = np.where(live, g.voxel(rng.integers(1, g.nx + 1, cap),
                                 rng.integers(1, g.ny + 1, cap), 1), 0)
    f32 = lambda a: np.where(live, a, 0).astype(np.float32)
    cols = dict(dx=f32(rng.uniform(-1, 1, cap)),
                dy=f32(rng.uniform(-1, 1, cap)), dz=np.zeros(cap, np.float32),
                i=vox.astype(np.int32), ux=f32(rng.normal(0, .1, cap)),
                uy=f32(rng.normal(0, .1, cap)), uz=f32(rng.normal(0, .1, cap)),
                w=f32(np.ones(cap)), live=live, np=np.int32(n_live))
    return (SJ.SpeciesState(**{k: jnp.asarray(v) for k, v in cols.items()}),
            ST.SpeciesState(**{k: torch.from_numpy(np.array(v))
                               for k, v in cols.items()}))


def _emission_pair():
    p = dict(nx=32, ny=8)
    sj = emission_jax.build(emission_jax.EmissionParams(**p))
    st = emission.build(emission.EmissionParams(**p), device="cpu")
    return sj, st


def _assert_lanes(a, b, acc_j, acc_t, rhob_j, rhob_t):
    for n in ("live", "i", "w"):
        np.testing.assert_array_equal(np.asarray(getattr(a, n)),
                                      np_(getattr(b, n)), err_msg=n)
    live = np.asarray(a.live)
    for n in LANE_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(a, n))[live],
                                   np_(getattr(b, n))[live], atol=3e-5,
                                   err_msg=n)
    assert int(a.np) == int(b.np)
    da, db = np.asarray(acc_j), np_(acc_t)
    assert np.abs(da - db).max() <= 1e-5 * max(np.abs(da).max(), 1e-30)
    assert_close_rel(np.asarray(rhob_j), rhob_t, 1e-5, 0.0, "rhob")


@pytest.mark.parametrize("cap,n_live", [(4096, 1500), (1200, 1190)])
def test_child_langmuir_matches_jax(cap, n_live):
    """One call on the diode's initial fields: the cathode's eligible faces
    emit into the free slots (all of them; with 10 free slots, the first
    10), deposit into rhob and walk an aged streak into acc."""
    sj, st = _emission_pair()
    state = sj.initialize()
    g_j, g_t = sj.grid, st.grid
    fc_j = IJ.load_interpolator(state.fields, g_j)
    fields_t = vt.FieldState(**{n: torch.from_numpy(np.array(getattr(
        state.fields, n))) for n in ST.FIELD_NAMES})
    fc_t = IT.load_interpolator(fields_t, g_t)
    assert np.array_equal(np.asarray(fc_j), fc_t.numpy())
    sp_j, sp_t = _species_pair(cap, n_live, g_j, seed=cap)
    rhob0 = np.random.default_rng(0).normal(0, 1e-3, g_j.nv).astype(
        np.float32)
    acc_j = jnp.zeros((g_j.nv, 12), jnp.float32)
    rng, step = jax.random.PRNGKey(3), 4
    em_j, em_t = sj.emitters[0], st.emitters[0]
    out_j, acc_j, rhob_j, _ = em_j([sp_j], state.fields, fc_j, acc_j,
                                   jnp.asarray(rhob0), g_j, jnp.int32(step),
                                   rng)
    ks = jax.random.split(jax.random.fold_in(rng, step), 7)
    M = em_t.M
    u = lambda k: torch.from_numpy(np.array(jax.random.uniform(k, (M,))))
    n = lambda k: torch.from_numpy(np.array(jax.random.normal(k, (M,))))
    draws = dict(par=u(ks[0]), perp1=n(ks[1]), perp2=n(ks[2]),
                 pos1=u(ks[3]), pos2=u(ks[4]), age=u(ks[5]))
    acc_t = torch.zeros((g_t.nv, 12))
    rhob_t = torch.from_numpy(rhob0.copy())
    out_t, acc_t, rhob_t = em_t.apply([sp_t], fc_t, acc_t, rhob_t, g_t,
                                      draws)
    _assert_lanes(out_j[0], out_t[0], acc_j, acc_t, rhob_j, rhob_t)
    new = np_(out_t[0].live) & ~np_(sp_t.live)
    assert new.sum() == min(16, cap - n_live)
    assert np.abs(np_(acc_t)).max() > 0
    # the draw's shapes are the ones apply takes
    mine = em_t.draw(torch.Generator().manual_seed(0), "cpu")
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in draws.items()}


def _inject_inputs(M, g, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    x = f32(rng.uniform(g.x0, g.x1, M))
    y = f32(rng.uniform(g.y0, g.y1, M))
    z = f32(rng.uniform(g.z0, g.z1, M))
    u = f32(rng.normal(0, 0.5, (3, M)))
    w = f32(np.where(rng.uniform(size=M) < 0.2, -1.0, rng.uniform(.5, 2, M)))
    age = f32(rng.uniform(0, 1, M))
    return x, y, z, u, w, age


@pytest.mark.parametrize("aged", [False, True])
def test_runtime_inject_matches_jax(aged):
    sim_j = vj.Simulation()
    sim_t = vt.Simulation(device="cpu")
    for sim in (sim_j, sim_t):
        sim.define_units(1.0, 1.0)
        sim.define_timestep(0.05)
        sim.define_periodic_grid((0, 0, 0), (1, 1, 0.5), (8, 8, 4))
        sim.set_domain_particle_bc(vj.BOUNDARY(1, 0, 0),
                                   vj.ABSORB_PARTICLES)
    g_j, g_t = sim_j.grid, sim_t.grid
    sp_j, sp_t = _species_pair(600, 300, g_j, seed=5)
    M = 200
    x, y, z, u, w, age = _inject_inputs(M, g_j, seed=6)
    rhob0 = np.zeros(g_j.nv, np.float32)
    out_j, acc_j, rhob_j = EJ.runtime_inject(
        sp_j, g_j, jnp.zeros((g_j.nv, 12)), jnp.asarray(rhob0), None,
        *map(jnp.asarray, (x, y, z, u[0], u[1], u[2], w)), -1.0,
        age=jnp.asarray(age) if aged else None, update_rhob=True)
    t = lambda a: torch.from_numpy(np.array(a))
    acc_t = torch.zeros((g_t.nv, 12))
    out_t, acc_t, rhob_t = ET.runtime_inject(
        sp_t, g_t, acc_t, t(rhob0), *map(t, (x, y, z, u[0], u[1], u[2], w)),
        -1.0, age=t(age) if aged else None, update_rhob=True)
    _assert_lanes(out_j, out_t, acc_j, acc_t, rhob_j, rhob_t)
    assert int(out_t.np) == int(out_t.live.sum())
    if aged:
        assert np.abs(np_(acc_t)).max() > 0


def test_runtime_inject_f64_exact_large_grid():
    """tests/test_inject_reconnection.py:67-122 for the port: an 8192-cell
    axis, positions at cell boundaries and their float32 neighbours."""
    n = 8192
    sim = vt.Simulation(seed=0, device="cpu")
    sim.define_units(1.0, 1.0)
    sim.define_timestep(1e-5)
    sim.define_periodic_grid((0.1, 0, 0), (1.1, 1.0 / n, 1.0 / n),
                             (n, 1, 1))
    g = sim.grid
    rng = np.random.default_rng(3)
    cells = rng.integers(0, n, 2000)
    bnd = 0.1 + cells / n
    xs = np.float32(np.concatenate([
        bnd, np.nextafter(bnd, np.float32(2.0), dtype=np.float32),
        np.nextafter(bnd, np.float32(0.0), dtype=np.float32),
        0.1 + rng.uniform(0, 1, 2000)]))
    xs = np.clip(xs, np.float32(0.1), np.float32(1.1))
    M = len(xs)

    def host_conv(v):
        s = float(n) * ((float(v) - g.x0) / (g.x1 - g.x0))
        iv = int(s)
        frac = (s - iv) * 2.0 - 1.0
        if iv == n:
            frac, iv = 1.0, n - 1
        return frac, iv + 1

    want = np.array([host_conv(v) for v in xs])
    sp = ST.SpeciesState(
        **{k: torch.zeros(M + 8) for k in ("dx", "dy", "dz", "ux", "uy",
                                           "uz", "w")},
        i=torch.zeros(M + 8, dtype=torch.int32),
        live=torch.zeros(M + 8, dtype=torch.bool),
        np=torch.zeros((), dtype=torch.int32))
    zeros = torch.zeros(M)
    sp2, _, _ = ET.runtime_inject(
        sp, g, torch.zeros((g.nv, 12)), torch.zeros(g.nv),
        torch.from_numpy(xs), torch.full((M,), g.y0 + 0.5 * g.dy),
        torch.full((M,), g.z0 + 0.5 * g.dz), zeros, zeros, zeros,
        torch.ones(M), -1e-9)
    want_ix = want[:, 1].astype(np.int64) + g.NX * (1 + g.NY * 1)
    np.testing.assert_array_equal(sp2.i[:M].numpy(), want_ix)
    np.testing.assert_allclose(sp2.dx[:M].numpy(), want[:, 0], atol=3e-5)
    # float64 on the device, as the host staging: equal after rounding
    np.testing.assert_array_equal(sp2.dx[:M].numpy(),
                                  want[:, 0].astype(np.float32))
