"""The port's 3-D push against vpic_tpu: the plain version of the 3-D push
with its residency epilogue against the Pallas kernel ``_kernel3d`` run in
interpret mode (residency=True, the deck's home maps) on the 16^3 deck of
tests/test_pallas3d.py, with and without reflecting x walls.

Tolerances: lane offsets and momenta 3e-5 (test_pallas.py:68; the TPU
kernel gathers its coefficients through split-bf16 one-hot dots), voxels,
emit marks, outbox validity and voxels and ``ores`` equal, the current
after unload_accumulator + synchronize_jf to 5e-7 + 1e-5 max|j|
(test_pallas.py:88-94)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu.ops.fields as FJ
import vpic_tpu.ops.interp as IJ
import vpic_tpu.ops.pallas_push as PPJ
import vpic_tpu.ops.pallas_push3d as PP3
import vpic_tpu.ops.residency as RESJ
import vpic_tpu_torch.ops.fields as F
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.ops.interp as I

from torch_parity import assert_close_rel, build3d_pair, np_, to_torch

torch.set_num_threads(2)

FIELDS = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live")


def _jax_push(sj, state, species, homes):
    """One residency push of vpic_tpu's 3-D kernel (interpret mode) and the
    current it leaves after the chart fold and accumulator unload."""
    g = sj.grid
    f = state.fields
    fcoef_T = IJ.load_interpolator_T(f, g, PPJ.table_width(g), mark=None,
                                     y_images=True)
    tab = PP3.to_chart_T(fcoef_T, g)
    acc_T = jnp.zeros((16, PP3.chart_width(g)), jnp.float32)
    qms = [(st.params.q, st.params.m) for st in sj.species]
    sps, acc_T, oflags, _, emits, obx, ores = PP3.fused_push3d_multi(
        species, tab, acc_T, g, qms, homes=homes, residency=True,
        out_cap=RESJ.OUT_CAP, dep_terms=3)
    acc_T = PPJ.fold_ghost_acc_T(PP3.fold_chart_acc(acc_T, g), g)
    f = IJ.unload_accumulator_T(FJ.clear_jf(f), acc_T, g)
    f = FJ.synchronize_jf(f, g)
    return sps, f, oflags, emits, obx, ores


@pytest.mark.parametrize("walls", [False, True])
def test_push3d_ref_matches_kernel3d(walls):
    sj, st = build3d_pair(walls)
    sj.pallas_residency = True
    assert sj._residency_mode() == st._residency_mode()
    slack = st._residency_mode()[1]
    s_jax = sj.initialize()
    (E,) = RESJ.extents(sj.grid, [5000], slack)
    sp0 = RESJ.slice_species(s_jax.species[0], E)
    sp0, home = PP3.brick_sort_p_home(sp0, sj.grid, extent=5000, slack=slack)
    sps_j, f_j, oflags, emits_j, obx_j, ores_j = _jax_push(
        sj, s_jax, [sp0], [home])
    assert not np.asarray(oflags[0]).any()

    s_t = to_torch(s_jax)
    sp_t = to_torch(s_jax.replace(species=(sp0,))).species[0]
    g = st.grid
    fcoef = I.load_interpolator(s_t.fields, g)
    acc = torch.zeros((g.nv, 12))
    sps_t, acc, emits_t, obx_t, ores_t, unf = FP3.fused_push3d_multi(
        [sp_t], fcoef, acc, g, [(-1.0, 1.0)],
        homes=[torch.as_tensor(np.array(home))], residency=True)
    assert int(unf) == 0
    a, b = sps_j[0], sps_t[0]
    live = np.asarray(a.live)
    assert np.array_equal(live, np_(b.live))
    assert np.array_equal(np.asarray(a.i), np_(b.i))
    for n in ("dx", "dy", "dz", "ux", "uy", "uz"):
        assert_close_rel(np.asarray(getattr(a, n))[live],
                         np_(getattr(b, n))[live], 0.0, 3e-5, n)
    # dead lanes pass through untouched in both
    for n in ("dx", "ux", "w"):
        assert np.array_equal(np.asarray(getattr(a, n))[~live],
                              np_(getattr(b, n))[~live]), n

    emit_j = np.asarray(emits_j[0]) > 0.5
    assert emit_j.any()
    assert np.array_equal(emit_j, np_(emits_t[0]))
    assert int(ores_j) == int(ores_t)
    obx_j = np.asarray(obx_j)
    valid = obx_j[8] > 0.5
    assert np.array_equal(valid, np_(obx_t.valid))
    assert np.array_equal(obx_j[3].astype(np.int32), np_(obx_t.vox))
    assert_close_rel(obx_j[[0, 1, 2, 4, 5, 6, 7]], np_(obx_t.f), 0.0, 3e-5,
                     "outbox")
    assert not np_(obx_t.f)[:, ~valid].any()

    F.clear_jf(s_t.fields)
    I.unload_accumulator(s_t.fields, acc, g)
    F.synchronize_jf(s_t.fields, g)
    for n in ("jfx", "jfy", "jfz"):
        assert_close_rel(getattr(f_j, n), getattr(s_t.fields, n), 1e-5,
                         5e-7, n)


def test_push3d_without_residency():
    """residency=False: the push alone, no outbox; the lanes agree with the
    residency push of the same input."""
    _, st = build3d_pair()
    s = st.initialize()
    g = st.grid
    sp, home = FP3.brick_sort_p_home(s.species[0], g, extent=5000)
    fcoef = I.load_interpolator(s.fields, g)
    a = FP3.fused_push3d_multi([sp], fcoef, torch.zeros((g.nv, 12)), g,
                               [(-1.0, 1.0)], homes=[home])
    b = FP3.fused_push3d_multi([sp], fcoef, torch.zeros((g.nv, 12)), g,
                               [(-1.0, 1.0)], homes=[home], residency=True)
    assert a[2] is None and a[3] is None and a[4] is None
    for n in FIELDS:
        assert torch.equal(getattr(a[0][0], n), getattr(b[0][0], n)), n
    assert torch.equal(a[1], b[1])
