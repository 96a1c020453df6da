"""The general push with a rank's remote faces (vpic_tpu_torch/ops/push.py:
a lane that reaches a face another rank owns parks with pend = face and
keeps its remaining displacement) against vpic_tpu's advance_p under
shard_map, rank by rank, from the same random lanes and interpolator
rows.  The port's ranks need no process group here: the push is
shard-local, so each rank runs in this process under a local Mesh.
Pend codes and voxels equal, offsets, momenta and remaining displacement
to 3e-5, the accumulator and rhob to 1e-6 of their largest value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu.grid as GJ
import vpic_tpu.ops.push as PJ
import vpic_tpu.state as SJ
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fused_push as FPT
import vpic_tpu_torch.ops.fused_push3d as FP3T
import vpic_tpu_torch.ops.push as PT
import vpic_tpu_torch.state as ST
from vpic_tpu_torch.parallel import mesh as M
from torch_parity import assert_close_rel, jax_sharded

Q, MASS = -1.0, 1.0
N = 600
# (topology, global cells, x-face particle bc): reflecting x walls on a
# decomposed x axis in 2-D; absorbing x walls and a decomposed z in 3-D
CASES = {"2d": ((2, 2, 1), (8, 8, 1), GJ.REFLECT_PARTICLES),
         "3d": ((1, 2, 2), (4, 6, 8), GJ.ABSORB_PARTICLES)}


def _grid(G, case):
    topology, n, xbc = CASES[case]
    g = G.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0, *n, *topology,
                                 dt=0.4, cvac=1.0, eps0=1.0)
    for face in (0, 3):
        g = g.with_bc(face, pbc=xbc)
    return g


def _inputs(case, seed=0):
    g = _grid(GJ, case)
    topo = CASES[case][0]
    rng = np.random.default_rng(seed)
    shape = tuple(topo) + (N,)
    xi = rng.integers(1, g.nx + 1, shape)
    yi = rng.integers(1, g.ny + 1, shape)
    zi = rng.integers(1, g.nz + 1, shape)
    live = rng.random(shape) < 0.9
    sp = dict(dx=rng.uniform(-1, 1, shape), dy=rng.uniform(-1, 1, shape),
              dz=rng.uniform(-1, 1, shape) if g.nz > 1 else np.zeros(shape),
              ux=rng.normal(0, 0.8, shape), uy=rng.normal(0, 0.8, shape),
              uz=rng.normal(0, 0.8, shape), w=rng.uniform(0.5, 1.5, shape))
    sp = {k: v.astype(np.float32) for k, v in sp.items()}
    sp["w"] = np.where(live, sp["w"], 0.0).astype(np.float32)
    sp["i"] = (xi + g.NX * (yi + g.NY * zi)).astype(np.int32)
    sp["live"] = live
    sp["np"] = live.sum(axis=-1).astype(np.int32)
    fcoef = (0.05 * rng.standard_normal(tuple(topo) + (g.nv, 18))
             ).astype(np.float32)
    return sp, fcoef


def _jax(case, sp, fcoef):
    g = _grid(GJ, case)

    def local(args):
        s, fc = args
        acc = jnp.zeros((g.nv, 12), jnp.float32)
        rhob = jnp.zeros((g.nv,), jnp.float32)
        r = PJ.advance_p(s, fc, g, Q, MASS, acc, rhob, max_streak=4)
        return r.species, r.acc, r.rhob_flat, r.pend_face, \
            jnp.stack(r.pend_disp)

    return jax_sharded(local, g, (SJ.SpeciesState(
        **{k: jnp.asarray(v) for k, v in sp.items()}), jnp.asarray(fcoef)))


def _port_rank(case, r, sp, fcoef, kernel_wrapper=False):
    g = _grid(GT, case)
    idx = GT.rank_coords(g, r)
    s = ST.SpeciesState(**{k: torch.from_numpy(np.array(v[idx]))
                           for k, v in sp.items()})
    fc = torch.from_numpy(np.array(fcoef[idx]))
    acc = torch.zeros((g.nv, 12))
    rhob = torch.zeros(g.nv)
    with M.use(M.Mesh(r, g.n_shards, "cpu", "local")):
        if kernel_wrapper:
            walls = PT.Walls(rhob)
            push = FPT.fused_push_multi if g.nz == 1 else \
                FP3T.fused_push3d_multi
            out = push([s], fc, acc, g, [(Q, MASS)], walls=walls)
            return out[0][0], acc, rhob, walls.pends[0], walls.disps[0]
        res = PT.advance_p(s, fc, g, Q, MASS, acc, rhob, max_streak=4)
    return res.species, acc, rhob, res.pend_face, torch.stack(res.pend_disp)


@pytest.mark.parametrize("case", sorted(CASES))
def test_remote_faces_match_jax_rank_by_rank(case):
    sp, fcoef = _inputs(case)
    ref_sp, ref_acc, ref_rhob, ref_pend, ref_disp = _jax(case, sp, fcoef)
    g = _grid(GT, case)
    parked = 0
    for r in range(g.n_shards):
        idx = GT.rank_coords(g, r)
        live = sp["live"][idx]
        for wrapper in (False, True):
            s, acc, rhob, pend, disp = _port_rank(case, r, sp, fcoef, wrapper)
            rp = np.asarray(ref_pend)[idx]
            np.testing.assert_array_equal(pend.numpy()[live], rp[live])
            np.testing.assert_array_equal(s.i.numpy()[live],
                                          np.asarray(ref_sp.i)[idx][live])
            np.testing.assert_array_equal(s.live.numpy(),
                                          np.asarray(ref_sp.live)[idx])
            for k in ("dx", "dy", "dz", "ux", "uy", "uz"):
                assert_close_rel(np.asarray(getattr(ref_sp, k))[idx][live],
                                 getattr(s, k).numpy()[live], 0.0, 3e-5,
                                 what=f"rank {r} {k}")
            assert_close_rel(np.asarray(ref_disp)[idx][:, live],
                             disp.numpy()[:, live], 0.0, 3e-5,
                             what=f"rank {r} remaining displacement")
            assert_close_rel(np.asarray(ref_acc)[idx], acc.numpy(), 1e-6,
                             what=f"rank {r} accumulator")
            assert_close_rel(np.asarray(ref_rhob)[idx], rhob.numpy(), 1e-6,
                             what=f"rank {r} rhob")
        remote = (rp >= 0) & (rp < PT.UNFINISHED) & live
        parked += int(remote.sum())
        # a lane parks only at a face this rank does not own
        bcs = GT.rank_particle_bc(g, r)
        assert all(bcs[f] == GT.P_REMOTE for f in np.unique(rp[remote]))
    assert parked > 20
