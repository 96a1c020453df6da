"""The collision operators on a decomposed grid (vpic_tpu_torch/collision.py
on each rank's lanes) against vpic_tpu's under shard_map, on the CPU.

The lanes come from the port's reconnection deck (16 x 8 x 1, 8 ppc) run
on (2, 1, 1) Gloo ranks with a cadence that never fires: after 3 steps
every live lane is in an interior voxel of its rank and lanes that
migrated sit in slots past the rank's initial count (arrivals are
appended), where the ops' shuffle reaches them (it sorts the whole
capacity).  Those bricks, stacked, are fed to vpic_tpu's three
Takizuka-Abe ops, a hard-sphere op (which counts large-pr candidates) and
Langevin, chained under shard_map with the one replicated key every shard
uses; each rank of the port applies the same ops to its brick with the
variates made from that key (tests/test_torch_collision.py's schedule).
Lanes match to that file's tolerance (live masks, voxels, weights and
offsets equal, momenta to 1e-5 max|u|), and each rank's large-pr tally
equals its shard's (vpic_tpu's shard_map returns the diag per shard).
The same never-firing run's energies equal one domain's (rtol 5e-4,
tests/test_sharded.py:45-46), and the dry run's collisional deck, firing
every step, keeps every lane with finite energies over 4 steps."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import vpic_tpu.collision as CJ
import vpic_tpu.state as SJ
import vpic_tpu_torch as vt
import vpic_tpu_torch.collision as CT
import vpic_tpu_torch.state as ST
from vpic_tpu.models import reconnection as RCJ
from vpic_tpu_torch.interop import state_to_numpy
from vpic_tpu_torch.models import reconnection as RCT
from vpic_tpu_torch.parallel import mesh as M

from test_torch_collision import (assert_species_match, binary_draws,
                                  n_f32)
from torch_parity import jax_sharded, launch_cpu

torch.set_num_threads(2)

DECK = dict(nx=16, ny=8, nz=1, nppc=8, Lx=8.0, Ly=4.0, Lz=1.0)
TOPO = (2, 1, 1)
STEPS, STEP = 3, 3


def _run(topology, n_steps):
    """The deck with a cadence that never fires, n_steps on this rank: its
    species as numpy, its initial live counts and the summed energies."""
    sim = RCT.build(RCT.ReconnectionParams(**DECK, topology=topology,
                                           tau_coll_interval=0),
                    device="cpu")
    state = sim.initialize()
    n0 = [int(sp.np) for sp in state.species]
    step = sim.make_step()
    for _ in range(n_steps):
        state = step(state)
    return dict(species=state_to_numpy(state)["species"], n0=n0,
                energies=sim.energies(state).double().numpy())


def _ops(C, sim):
    """The deck's three T&A ops (interval 1), a hard-sphere op between the
    electrons and the ions, and Langevin on the electrons."""
    ion, ele = sim.species[0].params, sim.species[1].params
    return list(sim.collision_ops) + [
        C.make_binary_op(C.hard_sphere_model(0.3, 0.3), 1, 0, ele, ion),
        C.make_langevin_op(1, ele, kT=0.04, nu=2.0)]


def test_collision_ops_per_rank_match_jax_shards(tmp_path):
    ranks = launch_cpu(_run, 2, tmp_path, TOPO, STEPS)
    sj = RCJ.build(RCJ.ReconnectionParams(**DECK, topology=TOPO,
                                          tau_coll_interval=1))
    st = RCT.build(RCT.ReconnectionParams(**DECK, topology=TOPO,
                                          tau_coll_interval=1),
                   device="cpu")
    gj, gt = sj.grid, st.grid
    ops_j, ops_t = _ops(CJ, sj), _ops(CT, st)
    stack = lambda k, n: np.stack([r["species"][k][n] for r in ranks]
                                  ).reshape(TOPO + np.shape(
                                      ranks[0]["species"][k][n]))
    sps = [SJ.SpeciesState(**{n: jnp.asarray(stack(k, n))
                              for n in ST.SPECIES_NAMES}) for k in range(2)]
    key = jax.random.PRNGKey(7)
    tally = ops_t[3].tally_key

    def local(args):
        species, rng = list(args[0]), args[1]
        diag = {tally: args[2]}
        for op in ops_j:
            if getattr(op, "has_diag", False):
                species, rng, diag = op(species, None, gj, jnp.int32(STEP),
                                        rng, diag)
            else:
                species, rng = op(species, None, gj, jnp.int32(STEP), rng)
        return tuple(species), diag[tally]

    tile = jnp.asarray(np.broadcast_to(np.asarray(key), TOPO + (2,)).copy())
    out_j, tally_j = jax_sharded(local, gj, (tuple(sps), tile,
                                             jnp.zeros(TOPO, jnp.int32)))

    # the port's draws: the JAX ops' key schedule along the chain (a binary
    # op hands on fold_in(fold_in(key, step), pr_rounds), Langevin the
    # second half of split(fold_in(key, step)))
    caps = [len(sp["dx"]) for sp in ranks[0]["species"]]
    chain, k = [], key
    for op in ops_t[:4]:
        i, j = op.pair
        kind = "uniform" if op is ops_t[3] else "normal"
        chain.append(binary_draws(k, STEP, (caps[i], caps[j]), i == j, 1,
                                  kind))
        k = jax.random.fold_in(jax.random.fold_in(k, STEP), 1)
    kl, _ = jax.random.split(jax.random.fold_in(k, STEP))
    chain.append(dict(normal=n_f32(kl, (3, caps[1]))))
    arrivals = 0
    for r, res in enumerate(ranks):
        idx = vt.grid.rank_coords(gt, r)
        species = [ST.SpeciesState(**{n: torch.from_numpy(np.array(a))
                                      for n, a in sp.items()})
                   for sp in res["species"]]
        for sp, n0 in zip(species, res["n0"]):
            live = sp.live.numpy()
            zi, rem = np.divmod(sp.i.numpy()[live], gt.sz)
            yi, xi = np.divmod(rem, gt.sy)
            assert ((xi >= 1) & (xi <= gt.nx) & (yi >= 1) & (yi <= gt.ny)
                    & (zi == 1)).all()
            arrivals += int(live[n0:].sum())
        nlarge = 0
        with M.use(M.Mesh(r, 2, "cpu", "local")):
            for op, d in zip(ops_t, chain):
                out = op.apply(species, gt, d)
                if isinstance(out, tuple):
                    species, n = out
                    nlarge += int(n)
                else:
                    species = out
        for k in range(2):
            a = SJ.SpeciesState(**{n: np.array(np.asarray(
                getattr(out_j[k], n))[idx]) for n in ST.SPECIES_NAMES})
            assert_species_match(a, species[k], f"rank {r} species {k}")
            assert not np.array_equal(a.ux, res["species"][k]["ux"])
        assert nlarge == int(np.asarray(tally_j)[idx])
    assert arrivals > 0


def test_never_firing_cadence_tracks_one_domain(tmp_path):
    """tests/test_sharded.py:45-46's bound: with tau_coll_interval 0 the
    decomposed run's energies equal one domain's to rtol 5e-4 (atol 1e-7
    of their sum) after 3 steps."""
    one = _run((1, 1, 1), STEPS)["energies"]
    for r in launch_cpu(_run, 2, tmp_path, TOPO, STEPS):
        np.testing.assert_allclose(r["energies"], one, rtol=5e-4,
                                   atol=1e-7 * one.sum())


def test_dryrun_collisional_case_keeps_lanes(tmp_path):
    """The dry run's collisional deck (2, 1, 1), T&A firing every step, 4
    steps: every staged lane held, energies finite."""
    res = launch_cpu(M.collisional_case, 2, tmp_path, "cpu", 4)
    lanes, staged, en = res[0]
    assert lanes == staged > 0 and np.isfinite(en).all()
    assert all(np.array_equal(r[2], en) for r in res)
