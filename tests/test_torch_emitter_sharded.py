"""Emitters on a decomposed grid (vpic_tpu_torch/emitter.py) against
vpic_tpu's sharded emitter (vpic_tpu/emitter.py:28-166) on the CPU.

tests/test_emitter_sharded.py's three tests on the port, with their
parametrisations: the packed (vox, face, valid) arrays equal vpic_tpu's
exactly, and their global face sets equal one domain's (no spurious seam
faces).  The emission deck's first-step census on 2 Gloo ranks equals the
port's on one domain and vpic_tpu's sharded count.  One ChildLangmuir call
per rank, fed the variates vpic_tpu's shard draws (its op under
shard_map, keys folded with the flat rank, vpic_tpu/emitter.py:147-156),
matches that shard's lanes to tests/test_torch_emitter.py's tolerances:
live masks, voxels and weights equal, offsets and momenta to atol 3e-5,
acc and rhob to 1e-5 of their largest value.  On (1, 2, 1) with a wide
perpendicular spread some new lanes' aged walk reaches a face another
rank owns: both packages park them on it (the walk's pend codes are
dropped, ROADMAP Queue 3)."""

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
from vpic_tpu_torch.parallel import mesh as M

from test_emitter_sharded import _global_faces
from test_torch_emitter import _assert_lanes
from torch_parity import jax_sharded, launch_cpu

torch.set_num_threads(2)


def _grids(topo):
    args = (0, 0, 0, 1.0, 1.0, 1.0 / 16, 16, 16, 1)
    return (vj.partition_periodic_box(*args),
            vj.partition_periodic_box(*args, *topo),
            vt.partition_periodic_box(*args, *topo))


def _check_packed(kind, region, topo):
    g1, gj, gt = _grids(topo)
    want = getattr(EJ, f"{kind}_components")(gj, region)
    got = getattr(ET, f"{kind}_components")(gt, region)
    assert len(got) == 3
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # an explicit shard scans one brick: the packed row without padding
    for s in ET._shard_iter(gt):
        v, f = ET.surface_components(gt, region, s) if kind == "surface" \
            else ET.volume_components(gt, region, s)
        assert np.array_equal(v, got[0][s][got[2][s]])
    ref = _global_faces(g1, getattr(EJ, f"{kind}_components")(g1, region),
                        (1, 1, 1))
    assert _global_faces(gt, got, topo) == ref and ref


@pytest.mark.parametrize("topo", [(2, 1, 1), (2, 2, 1)])
def test_sharded_surface_components_match_global(topo):
    _check_packed("surface", lambda x, y, z: (0.3 < x < 0.8)
                  and (0.2 < y < 0.6), topo)


@pytest.mark.parametrize("topo", [(2, 1, 1), (1, 2, 1)])
def test_sharded_volume_components_match_global(topo):
    _check_packed("volume", lambda x, y, z: (0.4 < x < 0.7)
                  and (0.3 < y < 0.8), topo)


def test_sharded_emission_deck_matches_single_domain(tmp_path):
    """The first-step census on (2, 1, 1) ranks equals one domain's and
    vpic_tpu's sharded count (eligibility is deterministic under the
    uniform bias field)."""
    one = emission.build(emission.EmissionParams(nx=32, ny=8), device="cpu")
    n1 = int(one.make_step()(one.initialize()).species[0].np)
    ranks = launch_cpu(M.emitter_case, 2, tmp_path, "cpu")
    sim = emission_jax.build(emission_jax.EmissionParams(topology=(2, 1, 1),
                                                         nx=32, ny=8))
    sim.use_pallas = False
    state = sim.make_step()(sim.initialize())
    n_jax = int(np.asarray(jax.device_get(state.species[0].live)).sum())
    assert sum(ranks) == n1 == n_jax > 0
    assert ranks[1] == 0          # the cathode lies in rank 0's brick


def _species(topo, cap, n_live, g, seed):
    """Per-brick species (leading topology dims) with ``n_live`` live lanes
    at random slots of interior voxels, as numpy columns."""
    rng = np.random.default_rng(seed)
    shape = tuple(topo) + (cap,)
    live = np.zeros(shape, bool)
    flat = live.reshape(-1, cap)
    for row in flat:
        row[rng.choice(cap, n_live, replace=False)] = True
    vox = np.where(live, g.voxel(rng.integers(1, g.nx + 1, shape),
                                 rng.integers(1, g.ny + 1, shape), 1), 0)
    f32 = lambda a: np.where(live, a, 0).astype(np.float32)
    return dict(dx=f32(rng.uniform(-1, 1, shape)),
                dy=f32(rng.uniform(-1, 1, shape)),
                dz=np.zeros(shape, np.float32), i=vox.astype(np.int32),
                ux=f32(rng.normal(0, .1, shape)),
                uy=f32(rng.normal(0, .1, shape)),
                uz=f32(rng.normal(0, .1, shape)), w=f32(np.ones(shape)),
                live=live, np=live.sum(-1).astype(np.int32))


@pytest.mark.parametrize("topo,ut_perp", [((2, 1, 1), 0.01),
                                          ((1, 2, 1), 0.5)])
def test_child_langmuir_per_rank_matches_jax_shard(topo, ut_perp):
    p = dict(nx=32, ny=8, topology=topo, ut_perp=ut_perp)
    sj = emission_jax.build(emission_jax.EmissionParams(**p))
    st = emission.build(emission.EmissionParams(**p), device="cpu")
    gj, gt = sj.grid, st.grid
    state = sj.initialize()
    cols = _species(topo, 1500, 1200, gj, seed=3)
    rng0, step = jax.random.PRNGKey(3), 4
    rhob0 = np.random.default_rng(0).normal(
        0, 1e-3, tuple(topo) + (gj.nv,)).astype(np.float32)
    tile = lambda a: jnp.asarray(np.broadcast_to(
        np.asarray(a), tuple(topo) + np.shape(a)).copy())
    em_j, em_t = sj.emitters[0], st.emitters[0]

    def local(args):
        fields, sp, rhob, rng = args
        fc = IJ.load_interpolator(fields, gj)
        acc = jnp.zeros((gj.nv, 12), jnp.float32)
        out, acc, rhob, _ = em_j([sp], fields, fc, acc, rhob, gj,
                                 jnp.int32(step), rng)
        return out[0], acc, rhob, fc

    sp_j = SJ.SpeciesState(**{k: jnp.asarray(v) for k, v in cols.items()})
    out_j, acc_j, rhob_j, fc_j = jax_sharded(
        local, gj, (state.fields, sp_j, jnp.asarray(rhob0), tile(rng0)))
    parked = 0
    for r in range(gt.n_shards):
        idx = vt.grid.rank_coords(gt, r)
        pick = lambda a: np.array(np.asarray(a)[idx])
        # the shard's variates: the key folded with the flat rank, then the
        # step (vpic_tpu/emitter.py:147-156)
        key = jax.random.fold_in(jax.random.fold_in(rng0, r), step)
        ks = jax.random.split(key, 7)
        u = lambda k: torch.from_numpy(np.array(
            jax.random.uniform(k, (em_t.M,))))
        n = lambda k: torch.from_numpy(np.array(
            jax.random.normal(k, (em_t.M,))))
        draws = dict(par=u(ks[0]), perp1=n(ks[1]), perp2=n(ks[2]),
                     pos1=u(ks[3]), pos2=u(ks[4]), age=u(ks[5]))
        fields_t = vt.FieldState(**{
            f: torch.from_numpy(pick(getattr(state.fields, f)))
            for f in ST.FIELD_NAMES})
        sp_t = ST.SpeciesState(**{k: torch.from_numpy(pick(v))
                                  for k, v in cols.items()})
        with M.use(M.Mesh(r, gt.n_shards, "cpu", "local")):
            fc_t = IT.load_interpolator(fields_t, gt)
            assert np.array_equal(pick(fc_j), fc_t.numpy())
            assert em_t.draw(torch.Generator(), "cpu")["age"].shape == \
                draws["age"].shape
            acc_t = torch.zeros((gt.nv, 12))
            rhob_t = torch.from_numpy(pick(rhob0))
            out_t, acc_t, rhob_t = em_t.apply([sp_t], fc_t, acc_t, rhob_t,
                                              gt, draws)
        a = SJ.SpeciesState(**{k: pick(getattr(out_j, k))
                               for k in ST.SPECIES_NAMES})
        _assert_lanes(a, out_t[0], pick(acc_j), acc_t, pick(rhob_j), rhob_t)
        # new lanes on the y faces of the brick (remote on (1, 2, 1))
        new = out_t[0].live.numpy() & ~cols["live"][idx]
        yi = (out_t[0].i.numpy() // gt.sy) % gt.NY
        on_face = np.abs(out_t[0].dy.numpy()) == 1.0
        parked += int((new & on_face & ((yi == 1) | (yi == gt.ny))).sum())
    assert (parked > 0) == (topo == (1, 2, 1))
