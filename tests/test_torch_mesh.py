"""The port's process-per-rank mesh (vpic_tpu_torch/parallel/mesh.py)
against vpic_tpu's shard_map collectives: flat-rank order, ppermute over
cartesian and joined partner tables, the sums.  The port side runs four
Gloo ranks of the CPU, once for the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as PS

import vpic_tpu.grid as GJ
from vpic_tpu.parallel.mesh import make_mesh
from vpic_tpu_torch import grid as GT
from vpic_tpu_torch.parallel import mesh as M
from torch_parity import launch_cpu

# the (4, 1, 1) x line spliced into two 2-rank rings (tests/
# test_join_domain.py:57): face 0 and face 3 partner tables
JOINED = {0: (1, 0, 3, 2), 3: (1, 0, 3, 2)}
TOPOLOGIES = ((1, 4, 1), (2, 2, 1))


def _grid(topology):
    return GT.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 1, *topology)


def _pairs(tab):
    return [(p, q) for q, p in enumerate(tab) if p >= 0]


def _rank_body():
    """Every collective the module checks, on this rank."""
    m = M.current()
    r = m.rank
    x = torch.arange(3, dtype=torch.float32) + 10.0 * r
    out = {}
    for topo in TOPOLOGIES:
        tabs = GT.halo_partners(_grid(topo))
        for f in range(6):
            out[topo, f] = m.ppermute(x, _pairs(tabs[f])).numpy()
    for f, tab in JOINED.items():
        out["joined", f] = m.ppermute(x, _pairs(tab)).numpy()
    a, b = m.ppermute([x, 2 * x], _pairs(JOINED[0]))
    out["two"] = (a.numpy(), b.numpy())
    out["sum"] = m.all_sum(torch.tensor([r + 1.0, 0.5])).numpy()
    out["max"] = m.all_max(torch.tensor([float(r), -float(r)])).numpy()
    got = m.gather_to_root(torch.full((2,), r, dtype=torch.int32))
    out["gather"] = None if got is None else [t.numpy() for t in got]
    parts = ([torch.full((2,), 7 * q, dtype=torch.int32) for q in range(4)]
             if r == 0 else None)
    out["scatter"] = m.scatter_from_root(
        parts, torch.zeros(2, dtype=torch.int32)).numpy()
    out["counts"] = m.exchange_counts([r + 1], [(r + 1) % 4], [(r - 1) % 4])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch_cpu(_rank_body, 4, tmp_path_factory.mktemp("mesh"))


def _jax_ppermute(topology, pairs):
    """vpic_tpu's ppermute over the flat mesh axes: each shard's x is its
    flat rank's arange(3) + 10 r; (px, py, pz, 3) out."""
    gj = GJ.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 1, *topology)
    mesh = make_mesh(gj)

    def local(x):
        y = jax.lax.ppermute(x[0, 0, 0], gj.mesh_axes, pairs)
        return y[None, None, None]

    n = int(np.prod(topology))
    x = (jnp.arange(3, dtype=jnp.float32)[None]
         + 10.0 * jnp.arange(n, dtype=jnp.float32)[:, None])
    spec = PS(*gj.mesh_axes)
    return np.asarray(jax.jit(shard_map(
        local, mesh=mesh, in_specs=spec, out_specs=spec))(
            x.reshape(tuple(topology) + (3,))))


def test_flat_rank_order_matches_vpic_tpu():
    topology = (2, 2, 2)
    gj = GJ.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 8, *topology)
    gt = GT.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 8, *topology)
    mesh = make_mesh(gj)
    spec = PS(*gj.mesh_axes)
    got = np.asarray(jax.jit(shard_map(
        lambda z: (GJ.flat_rank(gj) + z[0, 0, 0])[None, None, None],
        mesh=mesh, in_specs=spec, out_specs=spec))(
            jnp.zeros(topology, jnp.int32)))
    for r in range(8):
        assert got[GT.rank_coords(gt, r)] == r
    with M.use(M.Mesh(5, 8, "cpu", "local")):
        assert GT.flat_rank(gt) == 5


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_ppermute_cartesian_matches_jax(ranks, topology):
    """Each face's halo exchange: the port's partner tables and ppermute
    give every rank what vpic_tpu's whole-axis ppermute gives the shard."""
    g = _grid(topology)
    tabs = GT.halo_partners(g)
    for f in range(6):
        ax = GJ.FACE_AXIS[f]
        if topology[ax] == 1:
            assert all(p < 0 for p in tabs[f])
            continue
        ns = topology[ax]
        shift = 1 if f < 3 else -1
        gj = GJ.partition_periodic_box(0, 0, 0, 1, 1, 1, 8, 8, 1, *topology)
        mesh = make_mesh(gj)
        spec = PS(*gj.mesh_axes)
        x = np.arange(3, dtype=np.float32)[None] \
            + 10.0 * np.arange(4, dtype=np.float32)[:, None]
        ref = np.asarray(jax.jit(shard_map(
            lambda v: jax.lax.ppermute(
                v, gj.mesh_axes[ax],
                [(k, (k + shift) % ns) for k in range(ns)]),
            mesh=mesh, in_specs=spec, out_specs=spec))(
                jnp.asarray(x.reshape(tuple(topology) + (3,)))))
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res[topology, f],
                                          ref[GT.rank_coords(g, r)])


def test_ppermute_joined_matches_jax(ranks):
    """The join table's explicit flat-rank pairs (the twisted rings)."""
    g = _grid((4, 1, 1))
    for f, tab in JOINED.items():
        ref = _jax_ppermute((4, 1, 1), _pairs(tab))
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res["joined", f],
                                          ref[GT.rank_coords(g, r)])
    for r, res in enumerate(ranks):
        p = JOINED[0][r]
        np.testing.assert_array_equal(res["two"][0],
                                      np.arange(3) + 10.0 * p)
        np.testing.assert_array_equal(res["two"][1],
                                      2 * (np.arange(3) + 10.0 * p))


def test_all_sum_and_gather(ranks):
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["sum"], [10.0, 2.0])
        np.testing.assert_array_equal(res["max"], [3.0, 0.0])
        np.testing.assert_array_equal(res["scatter"], [7 * r, 7 * r])
        assert res["counts"] == [(r - 1) % 4 + 1]
    assert [a.tolist() for a in ranks[0]["gather"]] == \
        [[q, q] for q in range(4)]
    assert all(res["gather"] is None for res in ranks[1:])


def test_rank_face_tables():
    """A rank's face codes: interior faces of a decomposed axis are remote,
    edge ranks keep the global rule (vpic_tpu/ops/push.py:505-553)."""
    g = GT.partition_metal_box(0, 0, 0, 1, 1, 1, 8, 8, 1, 1, 2, 1)
    assert GT.rank_particle_bc(g, 0) == (-1, -1, -1, -1, GT.P_REMOTE, -1)
    assert GT.rank_particle_bc(g, 1) == (-1, GT.P_REMOTE, -1, -1, -1, -1)
    assert GT.rank_field_bc(g, 0)[4] == GT.REMOTE
    assert GT.rank_field_bc(g, 0)[1] == GT.PEC
    gp = _grid((1, 2, 1))
    for r in range(2):
        assert GT.rank_particle_bc(gp, r) == (0, 1, 0, 0, 1, 0)
        assert GT.rank_field_bc(gp, r) == (0, 1, 0, 0, 1, 0)


def test_transport_rule():
    assert M.choose_transport("cpu", 4) == (torch.device("cpu"), "gloo")
    with pytest.raises(ValueError):
        M.choose_transport("meta", 2)


def test_local_mesh_refuses_collectives():
    g = _grid((1, 2, 1))
    with pytest.raises(RuntimeError, match="one process per rank"):
        GT.flat_rank(g)
    m = M.Mesh(0, 2, "cpu", "local")
    with M.use(m):
        assert GT.flat_rank(g) == 0
        with pytest.raises(RuntimeError, match="process group"):
            m.all_sum(torch.ones(1))


def test_dryrun_decomposed_cases(capsys):
    """The decomposed smoke run (vpic_tpu/parallel/mesh.py:78-222's port):
    harris (1, 4, 1), the irregular join (64 lanes kept), the decomposed
    reflux (128 kept), the surface emitter (lanes emitted) and the
    collisional deck (lanes kept, energies finite) on Gloo ranks of the
    CPU."""
    M.dryrun(4, "cpu")
    out = capsys.readouterr().out
    for case in ("irregular-join ok", "sharded-reflux ok",
                 "sharded-emitter ok", "sharded-collisional (2,1,1) ok"):
        assert case in out
