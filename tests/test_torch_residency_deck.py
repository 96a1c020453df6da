"""The port's 3-D residency step against vpic_tpu's, on the CPU: the 16^3
deck of tests/test_pallas3d.py for 4 steps, with and without reflecting x
walls, against vpic_tpu's residency path (tests/test_residency.py:30-42,
the Pallas kernels in interpret mode), and over 6 steps with the state's
species tensors keeping their storage.

Tolerances: live counts, voxel multisets, home maps and rebucket counts
equal; rhob sum 1e-5 relative and energies 2e-5 of the largest
(test_residency.py:37-42)."""

import jax
import numpy as np
import pytest
import torch

import vpic_tpu_torch.ops.residency as RES
from vpic_tpu_torch.ops.fused_push3d import LANE_FIELDS as FIELDS

from torch_parity import build3d_pair, np_

torch.set_num_threads(2)


def _summary(sim, state, live_of, i_of):
    live = live_of(state.species[0])
    return (np.asarray(np_(sim.energies(state)), np.float64),
            int(live.sum()), float(np_(state.fields.rhob).sum()),
            np.sort(i_of(state.species[0])[live]))


@pytest.mark.parametrize("walls", [False, True])
def test_residency_step_matches_jax(walls):
    sj, st = build3d_pair(walls)
    sj.pallas_residency = True
    assert st._residency_mode() == sj._residency_mode()
    s_t = st.initialize()
    step = st.make_step()
    s_j = sj.initialize()
    adv = jax.jit(sj.make_advance())
    for _ in range(4):
        s_t = step(s_t)
        s_j = adv(s_j)
    e0, n0, r0, i0 = _summary(sj, s_j, lambda s: np.asarray(s.live),
                              lambda s: np.asarray(s.i))
    e1, n1, r1, i1 = _summary(st, s_t, lambda s: np_(s.live),
                              lambda s: np_(s.i))
    assert n0 == n1 == 5000
    assert abs(r0 - r1) <= 1e-5 * abs(r0) + 1e-6
    assert np.abs(e0 - e1).max() / np.abs(e0).max() < 2e-5
    assert np.array_equal(i0, i1)
    assert np.array_equal(np.asarray(s_j.diag["_chart_home0"]),
                          np_(s_t.diag["_chart_home0"]))
    assert int(s_j.diag["_res_rebuckets"]) == int(s_t.diag["_res_rebuckets"])
    assert s_t.diag["_res_valid"] is True
    assert int(s_t.diag["unfinished"]) == 0


def test_residency_step_keeps_the_species_storage():
    """The merge writes into the state's extent slices and a rebucket
    copies into them: over 6 residency steps every lane tensor of the state
    keeps its storage, the lanes past the extent stay dead, np is the live
    count, and the state still matches vpic_tpu's."""
    sj, st = build3d_pair(seed=1)
    sj.pallas_residency = True
    s_t = st.initialize()
    ptrs = {n: getattr(s_t.species[0], n).data_ptr() for n in FIELDS}
    step = st.make_step()
    s_j = sj.initialize()
    adv = jax.jit(sj.make_advance())
    for _ in range(6):
        s_t = step(s_t)
        s_j = adv(s_j)
        sp = s_t.species[0]
        assert {n: getattr(sp, n).data_ptr() for n in FIELDS} == ptrs
        assert int(sp.np) == int(sp.live.sum()) == 5000
    E = RES.extents(st.grid, st._live_bounds(), st._residency_mode()[1])[0]
    assert not s_t.species[0].live[E:].any()
    e0, n0, r0, i0 = _summary(sj, s_j, lambda s: np.asarray(s.live),
                              lambda s: np.asarray(s.i))
    e1, n1, r1, i1 = _summary(st, s_t, lambda s: np_(s.live),
                              lambda s: np_(s.i))
    assert n0 == n1 == 5000
    assert abs(r0 - r1) <= 1e-5 * abs(r0) + 1e-6
    assert np.abs(e0 - e1).max() / np.abs(e0).max() < 2e-5
    assert np.array_equal(i0, i1)
    assert np.array_equal(np.asarray(s_j.diag["_chart_home0"]),
                          np_(s_t.diag["_chart_home0"]))
    assert int(s_t.diag["_res_rebuckets"]) == int(s_j.diag["_res_rebuckets"])
