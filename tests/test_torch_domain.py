"""The port's domain vocabulary (vpic_tpu_torch/deck.py) against vpic_tpu's
(vpic_tpu/deck.py:146-250) on the CPU: size_domain, set_domain_geometry,
the join_domain self-join (the grids equal field for field), the join
between two domains, which needs decomposition and raises, and the host
pools sync_rng / rng with the uniform and normal draws (equal draw for
draw)."""

import numpy as np
import pytest
import torch

import vpic_tpu as vj
import vpic_tpu_torch as vt

from torch_parity import assert_same_grid

torch.set_num_threads(2)


def _sized(pkg, n=(12, 1, 6), geometry=None, joins=()):
    sim = pkg.Simulation(seed=3, **({"device": "cpu"} if pkg is vt else {}))
    sim.define_units(2.0, 0.5)
    sim.define_timestep(0.01)
    g = sim.size_domain(*n)
    if geometry is not None:
        g = sim.set_domain_geometry(**geometry)
    for face in joins:
        g = sim.join_domain(face, 0)
    assert g is sim.grid
    return sim


@pytest.mark.parametrize("geometry", [
    None,
    dict(x0=0.0, y0=-0.5e-6, z0=-0.025, dx=1e-3, dy=1e-6, dz=2.5e-3),
    dict(z0=1.5, dx=0.25),
    dict(y0=-3.0, dz=0.125),
])
def test_size_domain_and_geometry_match(geometry):
    sj, st = _sized(vj, geometry=geometry), _sized(vt, geometry=geometry)
    assert_same_grid(sj.grid, st.grid)
    g = st.grid
    # a particle-reflecting metal box of unit spacing, then the deck's
    # corner and spacings
    assert g.particle_bc == (vt.REFLECT_PARTICLES,) * 6
    assert g.field_bc == (vt.PEC,) * 6
    geometry = geometry or {}
    assert g.x0 == geometry.get("x0", 0.0)
    assert g.dx == pytest.approx(geometry.get("dx", 1.0))
    assert g.dz == pytest.approx(geometry.get("dz", 1.0))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_self_join_makes_the_axis_periodic(axis):
    lo = [0, 0, 0]
    lo[axis] = -1
    hi = [0, 0, 0]
    hi[axis] = 1
    faces = (vt.BOUNDARY(*lo), vt.BOUNDARY(*hi))
    sj, st = (_sized(pkg, n=(6, 5, 4), joins=faces) for pkg in (vj, vt))
    assert_same_grid(sj.grid, st.grid)
    g = st.grid
    for face in range(6):
        joined = face % 3 == axis
        assert (g.field_bc[face] == vt.PERIODIC) == joined
        assert (g.particle_bc[face] == 0) == joined
    # one face of the pair is enough: the self-join sets both
    one = _sized(vt, n=(6, 5, 4), joins=faces[:1])
    assert one.grid == st.grid


def test_join_between_domains_needs_decomposition():
    """A join between two domains needs a topology with both ranks in it
    (vpic_tpu's check; joins between ranks: tests/test_torch_join_ranks.py)."""
    st = _sized(vt)
    with pytest.raises(ValueError, match="n_shards"):
        st.join_domain(vt.BOUNDARY(0, -1, 0), 1, 0)
    with pytest.raises(ValueError, match="n_shards"):
        st.join_domain(vt.BOUNDARY(1, 0, 0), 0, 2)
    assert st.grid == _sized(vt).grid


def _draws(sim):
    out = []
    for pool in (sim.sync_rng(0), sim.rng(0)):
        out += [sim.uniform(pool, -2.0, 3.0) for _ in range(5)]
        out += [sim.normal(pool, 1.5, 0.25) for _ in range(5)]
    out += list(sim.sync_rng(1).random_sample(3))
    return np.asarray(out)


@pytest.mark.parametrize("reseed", [None, 11])
def test_sync_rng_uniform_normal_match(reseed):
    sims = [vj.Simulation(seed=4), vt.Simulation(seed=4, device="cpu")]
    if reseed is not None:
        for sim in sims:
            sim.seed_entropy(reseed)
    dj, dt = _draws(sims[0]), _draws(sims[1])
    assert np.array_equal(dj, dt)
    # the synchronized pool is not the per-rank one
    assert not np.array_equal(dt[:10], dt[10:20])
    assert ((dt[:5] >= -2.0) & (dt[:5] < 3.0)).all()
