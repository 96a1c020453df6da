"""The port's collision operators (vpic_tpu_torch/collision.py) against
vpic_tpu/collision.py on the CPU.

One application of every binary model (hard sphere, large-angle Coulomb,
Takizuka-Abe; intra- and interspecies; pr_rounds 1 and 4) and of every
unary op (the generic framework, Langevin, the two fluid models) is fed
the variates that jax.random makes from the JAX op's own keys, with the
JAX op's key schedule copied here (vpic_tpu/collision.py:248-257, :382,
:438, :463), and held to the JAX op's result: the shuffle permutation and
the helpers bit for bit, live masks, voxels and weights bit for bit,
momenta to 1e-5 max|u| (float32 rounding of sin/cos/log/rsqrt and the
scatter-add order), the large-pr tallies equal.  Then the physics oracles
of tests/test_collision.py run on the port's own torch.Generator, with the
same bounds."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu.collision as CJ
import vpic_tpu.grid as GJ
import vpic_tpu.state as SJ
import vpic_tpu_torch.collision as CT
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.state as ST

from torch_parity import np_

torch.set_num_threads(2)

MOM_RTOL = 1e-5


def grids(n=4, dt=0.1):
    return (dataclasses.replace(
                GJ.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, n), dt=dt),
            dataclasses.replace(
                GT.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, n), dt=dt))


def species_arrays(n, g, uth=(0.1, 0.1, 0.1), seed=0, cap=None, holes=0,
                   drift=(0.0, 0.0, 0.0), w=None):
    """tests/test_collision.py's make_species as numpy columns; ``holes``
    kills that many random live lanes (dead slots inside the live prefix)."""
    rng = np.random.RandomState(seed)
    cap = cap or n
    vox = [g.voxel(rng.randint(1, g.nx + 1), rng.randint(1, g.ny + 1),
                   rng.randint(1, g.nz + 1)) for _ in range(n)]
    live = np.zeros(cap, bool)
    live[:n] = True
    pad = lambda c: np.concatenate([c, np.zeros(cap - n)]).astype(np.float32)
    cols = dict(
        dx=np.zeros(cap, np.float32), dy=np.zeros(cap, np.float32),
        dz=np.zeros(cap, np.float32),
        i=np.concatenate([vox, np.zeros(cap - n)]).astype(np.int32),
        ux=pad(rng.normal(drift[0], uth[0], n)),
        uy=pad(rng.normal(drift[1], uth[1], n)),
        uz=pad(rng.normal(drift[2], uth[2], n)),
        w=pad(np.ones(n) if w is None else w(rng, n)))
    if holes:
        dead = rng.choice(n, holes, replace=False)
        live[dead] = False
        cols["w"][dead] = 0.0
        cols["i"][dead] = 0
    cols["live"] = live
    cols["np"] = np.int32(live.sum())
    return cols


def both(cols):
    """(vpic_tpu SpeciesState, port SpeciesState) of the same columns."""
    sj = SJ.SpeciesState(**{k: jnp.asarray(v) for k, v in cols.items()})
    st = ST.SpeciesState(**{k: torch.from_numpy(np.array(v))
                            for k, v in cols.items()})
    return sj, st


def u_f32(k, shape):
    return torch.from_numpy(np.array(jax.random.uniform(k, shape)))


def n_f32(k, shape):
    return torch.from_numpy(np.array(jax.random.normal(k, shape)))


def bits31(k, n):
    return torch.from_numpy(np.array(
        (jax.random.bits(k, (n,), jnp.uint32) >> 1).astype(jnp.int32)))


def binary_draws(key, step, caps, intra, pr_rounds, kind):
    """The variates make_binary_op draws (collision.py:248-257)."""
    base = jax.random.fold_in(key, step)
    n = caps[0] // 2 if intra else caps[0]
    out = []
    for r in range(pr_rounds):
        ks = jax.random.split(jax.random.fold_in(base, r), 6)
        d = dict(shuf_i=bits31(ks[0], caps[0]))
        if not intra:
            d["shuf_j"] = bits31(ks[1], caps[1])
        d["pr"] = u_f32(ks[2], (n,))
        d["phi"] = u_f32(ks[3], (n,))
        d["theta"] = (u_f32 if kind == "uniform" else n_f32)(ks[4], (n,))
        d["bal"] = u_f32(ks[5], (n,))
        out.append(d)
    return out


def assert_species_match(a, b, what=""):
    """JAX species ``a`` against the port's ``b``: live, voxels and weights
    bit for bit, momenta to MOM_RTOL max|u| and NaN where the JAX op's are
    (the large-angle Coulomb angle of a comoving pair is NaN in both, and
    reaches the momenta of dead lanes through a zero factor)."""
    assert np.array_equal(np.asarray(a.live), np_(b.live)), what
    assert np.array_equal(np.asarray(a.i), np_(b.i)), what
    assert np.array_equal(np.asarray(a.w), np_(b.w)), what
    for n in ("dx", "dy", "dz"):
        assert np.array_equal(np.asarray(getattr(a, n)), np_(getattr(b, n)))
    for n in ("ux", "uy", "uz"):
        x = np.asarray(getattr(a, n), np.float64)
        y = np_(getattr(b, n)).astype(np.float64)
        assert np.array_equal(np.isnan(x), np.isnan(y)), (what, n)
        ok = ~np.isnan(x)
        bound = MOM_RTOL * max(np.abs(x[ok]).max(), 1e-30)
        err = np.abs(x[ok] - y[ok]).max()
        assert err <= bound, (what, n, err)


# ---------------------------------------------------------------------------
# helpers, bit for bit
# ---------------------------------------------------------------------------

def test_shuffle_sort_and_partition_bit_equal():
    gj, gt = grids()
    cols = species_arrays(3000, gj, cap=4096, holes=300, seed=7)
    sj, st = both(cols)
    key = jax.random.PRNGKey(11)
    r = bits31(key, 4096)
    out_j = CJ.shuffle_sort(sj, key)
    out_t, order = CT.shuffle_sort(st, r)
    k = jnp.where(sj.live, sj.i, 2 ** 30)
    want = np.asarray(jnp.lexsort((jnp.asarray(r.numpy()), k)))
    assert np.array_equal(want, order.numpy())
    for n in ST.SPECIES_NAMES[:-1]:
        assert np.array_equal(np.asarray(getattr(out_j, n)),
                              np_(getattr(out_t, n))), n
    for a, b in zip(CJ.cell_partition(out_j, gj),
                    CT.cell_partition(out_t, gt)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_perp_vector_and_deflect():
    rng = np.random.default_rng(3)
    ur = rng.normal(size=(3, 5000)).astype(np.float32)
    ur[:, :50] = 0.0                      # comoving pairs
    ur[0, 50:100] = ur[1, 50:100]         # ties of the smallest component
    ang = rng.uniform(0, 1, (4, 5000)).astype(np.float32)
    j = [jnp.asarray(a) for a in ur]
    t = [torch.from_numpy(a) for a in ur]
    for a, b in zip(CJ._perp_vector(*j), CT._perp_vector(*t)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-6)
    args = [2 * ang[0] - 1, ang[1], np.cos(ang[2]), np.sin(ang[2])]
    dj = CJ._deflect(*j, *[jnp.asarray(np.float32(a)) for a in args])
    dt_ = CT._deflect(*t, *[torch.from_numpy(np.float32(a)) for a in args])
    for a, b in zip(dj, dt_):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(ur).max())


# ---------------------------------------------------------------------------
# one application against the JAX op, with JAX's draws
# ---------------------------------------------------------------------------

def _models(gj, spp_i, spp_j):
    """name -> (JAX model, the port's)."""
    return dict(
        hs=(CJ.hard_sphere_model(0.3, 0.3), CT.hard_sphere_model(0.3, 0.3)),
        lac=(CJ.large_angle_coulomb_model(-1.0, 1.0, 1.0, 5.0, bmax=0.35),
             CT.large_angle_coulomb_model(-1.0, 1.0, 1.0, 5.0, bmax=0.35)))


CASES = [(m, intra, rounds) for m in ("hs", "lac") for intra in (True, False)
         for rounds in (1, 4)] + [("ta", True, 1), ("ta", False, 1)]


@pytest.mark.parametrize("model,intra,rounds", CASES)
def test_binary_op_matches_jax(model, intra, rounds):
    gj, gt = grids(dt=0.2)
    se = SJ.SpeciesParams("e", -1.0, 1.0, 4096, id=0)
    si = SJ.SpeciesParams("i", 1.0, 5.0, 3072, id=1)
    wvar = lambda rng, n: rng.uniform(0.5, 2.0, n)
    ce = species_arrays(3000, gj, uth=(0.2, 0.1, 0.15), seed=1, cap=4096,
                        holes=100, w=wvar, drift=(0.3, 0, 0))
    ci = species_arrays(2000, gj, uth=(0.05, 0.05, 0.05), seed=2, cap=3072,
                        w=wvar)
    (ej, et), (ij, it) = both(ce), both(ci)
    j_idx = 0 if intra else 1
    spj = se if intra else si
    step = 3
    if model == "ta":
        op_j = CJ.make_takizuka_abe_op(0, j_idx, se, spj, gj, n0=50.0,
                                       interval=1)
        op_t = CT.make_takizuka_abe_op(0, j_idx, se, spj, gt, n0=50.0,
                                       interval=1)
        kind = "normal"
    else:
        mj, mt = _models(gj, se, spj)[model]
        op_j = CJ.make_binary_op(mj, 0, j_idx, se, spj, interval=1,
                                 pr_rounds=rounds)
        op_t = CT.make_binary_op(mt, 0, j_idx, se, spj, interval=1,
                                 pr_rounds=rounds)
        kind = mt.variate
    key = jax.random.PRNGKey(5)
    diag0 = op_j.diag_init() if hasattr(op_j, "diag_init") else {}
    out_j, _, dj = op_j([ej, ij], None, gj, jnp.int32(step), key, diag0)
    caps = (4096, 4096 if intra else 3072)
    draws = binary_draws(key, step, caps, intra, rounds, kind)
    out_t, nlarge = op_t.apply([et, it], gt, draws)
    for k in range(2):
        assert_species_match(out_j[k], out_t[k], f"species {k}")
    if op_t.tally_key is None:
        assert not dj and int(nlarge) == 0
    else:
        assert int(dj[op_t.tally_key]) == int(nlarge)
    # something scattered
    assert not np.array_equal(np.asarray(out_j[0].ux),
                              np.asarray(CJ.shuffle_sort(ej, key).ux))


def test_binary_op_cadence_and_diag():
    """interval: fires on multiples only, never for interval <= 0; the
    tally key is carried (and created) through the diag dict."""
    gj, gt = grids()
    spp = ST.SpeciesParams("a", 1.0, 1.0, 512)
    cols = species_arrays(500, gj, cap=512)
    st = both(cols)[1]
    gen = torch.Generator().manual_seed(0)
    for interval, fires in ((3, (0, 3)), (0, ()), (-1, ())):
        op = CT.make_binary_op(CT.hard_sphere_model(0.3, 0.3), 0, 0, spp,
                               spp, interval=interval)
        assert op.interval == interval
        assert set(op.diag_init()) == {"coll_large_pr:hard sphere:0:0"}
        for step in range(5):
            out, diag = op([st], None, gt, step, gen, {})
            assert list(diag) == ["coll_large_pr:hard sphere:0:0"]
            changed = not torch.equal(out[0].ux, st.ux)
            assert changed == (step in fires), (interval, step)
    ta = CT.make_takizuka_abe_op(0, 0, spp, spp, gt)
    assert not hasattr(ta, "diag_init")
    assert ta([st], None, gt, 0, gen, {"x": 1})[1] == {"x": 1}
    cumulative = CT.BinaryModel("cumulative", lambda ur, p: ur,
                                lambda *a: a, {}, saturates=True)
    with pytest.raises(ValueError, match="sub-cycling"):
        CT.make_binary_op(cumulative, 0, 0, spp, spp, pr_rounds=2)


def _unary_pair(name, gj, gt, spp_j, spp_t):
    """(JAX op, port op, JAX collide variates from its key)."""
    if name == "langevin":
        return (CJ.make_langevin_op(0, spp_j, kT=0.04, nu=2.0),
                CT.make_langevin_op(0, spp_t, kT=0.04, nu=2.0))
    if name == "hs_fluid":
        kw = dict(n_bg=40.0, radius=0.2, m_bg=5.0, kT_bg=0.01,
                  vd=(0.0, 0.0, 0.1))
        return (CJ.make_hard_sphere_fluid_op(0, spp_j, **kw),
                CT.make_hard_sphere_fluid_op(0, spp_t, **kw))
    if name == "lac_fluid":
        kw = dict(n_bg=40.0, q_bg=1.0, m_bg=5.0, bmax=0.2, kT_bg=0.02)
        return (CJ.make_large_angle_coulomb_fluid_op(0, spp_j, **kw),
                CT.make_large_angle_coulomb_fluid_op(0, spp_t, **kw))
    rate_j = CJ.hard_sphere_fluid_rate(n_bg=50.0, radius=0.2)
    rate_t = CT.hard_sphere_fluid_rate(n_bg=50.0, radius=0.2)

    def collide_j(key, ux, uy, uz, hit):
        n = jax.random.normal(key, (3,) + ux.shape)
        nn = n / jnp.sqrt(jnp.sum(n * n, 0))
        s = jnp.sqrt(ux ** 2 + uy ** 2 + uz ** 2)
        return (jnp.where(hit, s * nn[0], ux), jnp.where(hit, s * nn[1], uy),
                jnp.where(hit, s * nn[2], uz))

    def collide_t(v, ux, uy, uz, hit):
        n = v["normal"]
        nn = n / torch.sqrt(torch.sum(n * n, 0))
        s = torch.sqrt(ux * ux + uy * uy + uz * uz)
        return (torch.where(hit, s * nn[0], ux),
                torch.where(hit, s * nn[1], uy),
                torch.where(hit, s * nn[2], uz))

    return (CJ.make_unary_op(0, rate_j, collide_j),
            CT.make_unary_op(0, rate_t, collide_t))


@pytest.mark.parametrize("name", ["generic", "langevin", "hs_fluid",
                                  "lac_fluid"])
def test_unary_op_matches_jax(name):
    gj, gt = grids(dt=0.05)
    cap = 4096
    spp_j = SJ.SpeciesParams("e", -1.0, 1.0, cap)
    spp_t = ST.SpeciesParams("e", -1.0, 1.0, cap)
    cols = species_arrays(3500, gj, uth=(0.05, 0.05, 0.05), cap=cap,
                          holes=200, drift=(0, 0, 0.4), seed=4)
    sj, st = both(cols)
    op_j, op_t = _unary_pair(name, gj, gt, spp_j, spp_t)
    key, step = jax.random.PRNGKey(9), 2
    out_j, _ = op_j([sj], None, gj, jnp.int32(step), key)
    base = jax.random.fold_in(key, step)
    if name == "langevin":
        k, _ = jax.random.split(base)
        draws = dict(normal=n_f32(k, (3, cap)))
    else:
        k1, k2, _ = jax.random.split(base, 3)
        if name == "generic":
            coll = dict(normal=n_f32(k2, (3, cap)))
        else:
            kk = jax.random.split(k2, 3)
            coll = dict(ub=n_f32(kk[0], (3, cap)),
                        angle=u_f32(kk[1], (cap,)),
                        phi=u_f32(kk[2], (cap,)))
        draws = dict(hit=u_f32(k1, (cap,)), collide=coll)
    out_t = op_t.apply([st], gt, draws)
    assert_species_match(out_j[0], out_t[0], name)
    assert not np.array_equal(cols["uz"], np_(out_t[0].uz))
    # the op's own draw has the shapes the apply takes
    gen = torch.Generator().manual_seed(1)
    mine = op_t.draw(gen, [st])
    flat = lambda d: {k: (v.shape, v.dtype) for k, v in d.items()
                      if isinstance(v, torch.Tensor)}
    assert flat(mine) == flat(draws)
    if "collide" in draws:
        assert flat(mine["collide"]) == flat(draws["collide"])


# ---------------------------------------------------------------------------
# the physics oracles of tests/test_collision.py, on the port's generator
# ---------------------------------------------------------------------------

def make_species(n, uth=(0.1, 0.1, 0.1), seed=0, cap=None, g=None):
    return both(species_arrays(n, g, uth=uth, seed=seed, cap=cap))[1]


def moments(sp):
    m = sp.live
    u = torch.stack([sp.ux[m], sp.uy[m], sp.uz[m]]).double()
    return u.sum(dim=1).numpy(), float((u * u).sum())


def test_hard_sphere_conserves_momentum_energy():
    gj, g = grids()
    spp = ST.SpeciesParams("a", 1.0, 1.0, 4096)
    sp = make_species(2048, uth=(0.2, 0.2, 0.2), g=gj, cap=4096)
    op = CT.make_binary_op(CT.hard_sphere_model(0.3, 0.3), 0, 0, spp, spp)
    p0, e0 = moments(sp)
    species = op([sp], None, g, 0, torch.Generator().manual_seed(0))
    p1, e1 = moments(species[0])
    np.testing.assert_allclose(p1, p0, atol=2e-4 * math.sqrt(e0))
    assert abs(e1 - e0) / e0 < 1e-4
    assert not torch.equal(sp.ux, species[0].ux)


def test_takizuka_abe_isotropizes():
    gj, g = grids(dt=0.5)
    spp = ST.SpeciesParams("e", -1.0, 1.0, 8192)
    sp = make_species(8192, uth=(0.3, 0.1, 0.1), g=gj, cap=8192)
    op = CT.make_takizuka_abe_op(0, 0, spp, spp, g, log_lambda=10.0,
                                 n0=200.0, interval=1)
    gen = torch.Generator().manual_seed(1)
    _, e0 = moments(sp)

    def Ts(s):
        return [float(torch.var(u[s.live].double(), correction=0))
                for u in (s.ux, s.uy, s.uz)]

    T0 = Ts(sp)
    aniso0 = T0[0] / (0.5 * (T0[1] + T0[2]))
    species = [sp]
    for step in range(30):
        species = op(species, None, g, step, gen)
    T1 = Ts(species[0])
    aniso1 = T1[0] / (0.5 * (T1[1] + T1[2]))
    _, e1 = moments(species[0])
    assert abs(e1 - e0) / e0 < 5e-3
    assert aniso0 > 5.0
    assert aniso1 < 0.6 * aniso0


def test_interspecies_coulomb_momentum_exchange():
    gj, g = grids(dt=0.2)
    se = ST.SpeciesParams("e", -1.0, 1.0, 4096, id=0)
    si = ST.SpeciesParams("i", 1.0, 5.0, 4096, id=1)
    spe = make_species(4096, uth=(0.05, 0.05, 0.05), seed=1, g=gj)
    spe = spe.replace(ux=spe.ux + 0.3)
    spi = make_species(4096, uth=(0.02, 0.02, 0.02), seed=2, g=gj)
    model = CT.large_angle_coulomb_model(-1.0, 1.0, 1.0, 5.0, bmax=0.35)
    op = CT.make_binary_op(model, 0, 1, se, si, interval=1)
    gen = torch.Generator().manual_seed(2)
    px = lambda s: float(s.ux[s.live].double().sum())
    pe0 = px(spe)
    ptot0 = pe0 + 5.0 * px(spi)
    species = [spe, spi]
    for step in range(20):
        species = op(species, None, g, step, gen)
    pe1 = px(species[0])
    ptot1 = pe1 + 5.0 * px(species[1])
    assert abs(ptot1 - ptot0) < 2e-3 * abs(pe0)
    assert pe1 < 0.8 * pe0


def test_langevin_thermalizes():
    gj, g = grids(dt=0.1)
    spp = ST.SpeciesParams("e", -1.0, 1.0, 8192)
    sp = make_species(8192, uth=(0.01, 0.01, 0.01), g=gj)
    kT = 0.04
    op = CT.make_langevin_op(0, spp, kT=kT, nu=2.0, interval=1)
    gen = torch.Generator().manual_seed(3)
    species = [sp]
    for step in range(40):
        species = op(species, None, g, step, gen)
    var = float(torch.var(species[0].ux[species[0].live].double(),
                          correction=0))
    np.testing.assert_allclose(var, kT, rtol=0.1)


def test_unary_framework():
    gj, g = grids(dt=0.05)
    sp = make_species(4096, uth=(0.01, 0.01, 0.01), g=gj)
    sp = sp.replace(uz=sp.uz + 0.5)
    rate = CT.hard_sphere_fluid_rate(n_bg=50.0, radius=0.2)

    def collide(v, ux, uy, uz, hit):
        n = v["normal"]
        nn = n / torch.sqrt(torch.sum(n * n, 0))
        s = torch.sqrt(ux ** 2 + uy ** 2 + uz ** 2)
        return (torch.where(hit, s * nn[0], ux),
                torch.where(hit, s * nn[1], uy),
                torch.where(hit, s * nn[2], uz))

    op = CT.make_unary_op(0, rate, collide, interval=1)
    gen = torch.Generator().manual_seed(4)
    species = [sp]
    mean_uz = lambda s: float(s.uz[s.live].double().mean())
    uz0, e0 = mean_uz(sp), moments(sp)[1]
    for step in range(10):
        species = op(species, None, g, step, gen)
    assert mean_uz(species[0]) < 0.5 * uz0
    assert abs(moments(species[0])[1] - e0) / e0 < 1e-3


def test_fluid_collision_models():
    gj, g = grids(dt=0.05)
    spp = ST.SpeciesParams("e", -1.0, 1.0, 4096)
    gen = torch.Generator().manual_seed(9)
    for op in (CT.make_hard_sphere_fluid_op(0, spp, n_bg=40.0, radius=0.2,
                                            m_bg=5.0),
               CT.make_large_angle_coulomb_fluid_op(0, spp, n_bg=40.0,
                                                    q_bg=1.0, m_bg=5.0,
                                                    bmax=0.2)):
        sp = make_species(4096, uth=(0.01, 0.01, 0.01), g=gj)
        sp = sp.replace(uz=sp.uz + 0.4)
        species = [sp]
        uz0 = float(sp.uz.double().mean())
        for step in range(12):
            species = op(species, None, g, step, gen)
        assert float(species[0].uz.double().mean()) < 0.9 * uz0


def test_large_pr_subcycling_compensates():
    """pr_rounds compensation (tests/test_collision.py:186-247): R = 4 at
    pr = 3 gives ~3x the transverse heating of R = 1, and the saturation
    tally fires for R = 1 only."""
    gj, g = grids(dt=0.1)
    se = ST.SpeciesParams("b", -1.0, 1.0, 4096, id=0)
    st_ = ST.SpeciesParams("t", 1.0, 1e6, 4096, id=1)
    theta0, PR = 0.05, 3.0

    def rate(ur, p):
        return PR / (g.dt * 1 / g.dV)

    def angle(v, ur, p, pr):
        return (torch.full_like(ur, math.cos(theta0)),
                torch.full_like(ur, math.sin(theta0)))

    model = CT.BinaryModel("smallangle", rate, angle, {})

    def run(pr_rounds, n_apps=8):
        beam = make_species(2048, uth=(0.0, 0.0, 0.0), seed=3, g=gj,
                            cap=4096)
        beam = beam.replace(ux=torch.where(beam.live, 1.0, 0.0))
        tgt = make_species(g.nx * g.ny * g.nz, uth=(0, 0, 0), seed=4, g=gj,
                           cap=4096)
        vox = [g.voxel(x, y, z) for z in range(1, g.nz + 1)
               for y in range(1, g.ny + 1) for x in range(1, g.nx + 1)]
        vi = np.zeros(4096, np.int32)
        vi[:len(vox)] = vox
        tgt = tgt.replace(i=torch.from_numpy(vi), ux=tgt.ux * 0,
                          uy=tgt.uy * 0, uz=tgt.uz * 0)
        op = CT.make_binary_op(model, 0, 1, se, st_, sample=1.0, interval=1,
                               pr_rounds=pr_rounds)
        diag = op.diag_init()
        species = [beam, tgt]
        gen = torch.Generator().manual_seed(5)
        for step in range(n_apps):
            species, diag = op(species, None, g, step, gen, diag)
        b = species[0]
        t_perp = float((b.uy[b.live].double() ** 2
                        + b.uz[b.live].double() ** 2).mean())
        return t_perp, int(diag["coll_large_pr:smallangle:0:1"])

    tp1, nl1 = run(1)
    tp4, nl4 = run(4)
    ratio = tp4 / tp1
    assert 2.2 < ratio < 3.8, f"transverse heating ratio {ratio}"
    assert nl1 > 0
    assert nl4 == 0


def test_ops_draw_from_the_generator_only():
    """The same generator state gives the same application; another seed
    another one (no global randoms)."""
    gj, g = grids()
    spp = ST.SpeciesParams("a", 1.0, 1.0, 1024)
    sp = make_species(1000, uth=(0.2, 0.2, 0.2), g=gj, cap=1024)
    op = CT.make_takizuka_abe_op(0, 0, spp, spp, g, n0=10.0)
    run = lambda seed: op([sp], None, g, 0,
                          torch.Generator().manual_seed(seed))[0]
    torch.manual_seed(123)
    a = run(0)
    torch.manual_seed(456)
    b, c = run(0), run(1)
    assert torch.equal(a.ux, b.ux) and not torch.equal(a.ux, c.ux)
