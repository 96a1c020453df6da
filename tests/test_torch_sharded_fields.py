"""The field ops' decomposed halves (halo exchange, shared-face sums and
averages, edge ranks' local rules, the all-sums) against vpic_tpu's
under shard_map: one plain-trio step with synchronize_jf, both Marder
cleaners, synchronize_tang_e_norm_b, synchronize_rho and the field
energies, from the same random per-rank fields, on (1, 2, 1) and
(2, 2, 1).  Each field to 1e-6 of its largest value, the all-summed
scalars to 1e-5 (another summation order across ranks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu.grid as GJ
import vpic_tpu.ops.fields as FJ
import vpic_tpu.state as SJ
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fields as FT
import vpic_tpu_torch.state as ST
from torch_parity import MAT, assert_close_rel, jax_sharded, launch_cpu

# (topology, global cells, field bc): pec x walls, periodic y and z; the
# x walls land on a decomposed axis in (2, 2, 1)
CASES = {(1, 2, 1): (8, 12, 1), (2, 2, 1): (8, 12, 1)}
FBC = (GJ.PEC, GJ.PERIODIC, GJ.PERIODIC, GJ.PEC, GJ.PERIODIC, GJ.PERIODIC)


def _grid(G, topology, n):
    g = G.partition_periodic_box(0, 0, 0, 1.0, 1.2, 0.6, *n, *topology,
                                 dt=0.05, cvac=1.0, eps0=1.0)
    for face, bc in enumerate(FBC):
        if g.topology[face % 3] == 1 or bc != GJ.PERIODIC:
            g = g.with_bc(face, fbc=bc)
    return g


def _ops(F, f, g, m):
    """The same sequence in either package (functional in vpic_tpu, in
    place in the port)."""
    f = F.synchronize_jf(f, g)
    f = F.advance_b(f, g, 0.5)
    f = F.advance_e(f, g, m, 0.0)
    f = F.advance_b(f, g, 0.5)
    f = F.compute_div_e_err(f, g, m)
    f = F.clean_div_e(f, g, m)
    f = F.compute_div_b_err(f, g)
    f = F.clean_div_b(f, g)
    f, err = F.synchronize_tang_e_norm_b(f, g)
    f = F.synchronize_rho(f, g)
    return f, err, F.all_sum(F.energy_f(f, g, m), g)


def _inputs(topology, n, seed=0):
    g = _grid(GJ, topology, n)
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(tuple(topology) + g.shape)
            .astype(np.float32) for k in ST.FIELD_NAMES}


def _rank(topology, n, arrs):
    g = _grid(GT, topology, n)
    idx = GT.rank_coords(g, GT.flat_rank(g))
    f = ST.FieldState(**{k: torch.from_numpy(a[idx].copy())
                         for k, a in arrs.items()})
    m = ST.MaterialCoeffs(**{k: torch.tensor(v) for k, v in MAT.items()})
    f, err, en = _ops(FT, f, g, m)
    return ({k: getattr(f, k).numpy() for k in ST.FIELD_NAMES},
            float(err), en.numpy())


@pytest.mark.parametrize("topology", sorted(CASES))
def test_sharded_field_step_matches_jax(topology, tmp_path):
    n = CASES[topology]
    arrs = _inputs(topology, n)
    gj = _grid(GJ, topology, n)
    assert _grid(GT, topology, n).field_bc == gj.field_bc
    mj = SJ.MaterialCoeffs(**{k: jnp.float32(v) for k, v in MAT.items()})
    fj = SJ.FieldState(**{k: jnp.asarray(a) for k, a in arrs.items()})
    ref_f, ref_err, ref_en = jax_sharded(
        lambda f: _ops(FJ, f, gj, mj), gj, fj)
    out = launch_cpu(_rank, int(np.prod(topology)), tmp_path, topology, n,
                     arrs)
    g = _grid(GT, topology, n)
    for r, (fields, err, en) in enumerate(out):
        idx = GT.rank_coords(g, r)
        for k in ST.FIELD_NAMES:
            assert_close_rel(np.asarray(getattr(ref_f, k))[idx], fields[k],
                             1e-6, what=f"rank {r} {k}")
        assert_close_rel(np.asarray(ref_err)[idx], err, 1e-5,
                         what=f"rank {r} desync error")
        assert_close_rel(np.asarray(ref_en)[idx], en, 1e-5,
                         what=f"rank {r} energies")
