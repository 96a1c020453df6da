"""Port ghost fills, local field BCs, shared-face syncs and the
interpolator/accumulator against vpic_tpu on the same random numpy fields,
to 1e-6 max|a|, over a harris grid (pec x walls), a grid with symmetric /
pmc / absorbing faces and a fully periodic one."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu.ops.fields as FJ
import vpic_tpu.ops.interp as IJ
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fields as FT
import vpic_tpu_torch.ops.interp as IT
import vpic_tpu_torch.state as ST

from torch_parity import GRIDS, assert_close_rel, check_field_op, field_pair

torch.set_num_threads(2)

NAMES = ("ghost_tang_b", "ghost_norm_e", "ghost_div_b", "adjust_tang_e",
         "adjust_norm_b", "adjust_div_e_err", "adjust_jf", "adjust_rhof",
         "adjust_rhob", "synchronize_jf", "synchronize_rho",
         "synchronize_tang_e_norm_b")


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("op", NAMES)
def test_bc_op_matches_jax(op, grid):
    fn_j, fn_t = getattr(FJ, op), getattr(FT, op)
    check_field_op(lambda f, g, m: fn_j(f, g), lambda f, g, m: fn_t(f, g),
                   grid)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("op", ["clear_jf", "clear_rhof"])
def test_clear_matches_jax(op, grid):
    fn_j, fn_t = getattr(FJ, op), getattr(FT, op)
    check_field_op(lambda f, g, m: fn_j(f), lambda f, g, m: fn_t(f), grid)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_load_interpolator_matches_jax(grid):
    check_field_op(lambda f, g, m: IJ.load_interpolator(f, g),
                   lambda f, g, m: IT.load_interpolator(f, g), grid)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_unload_accumulator_matches_jax(grid):
    (gj, fj, _), (gt, ft, _) = field_pair(grid, seed=1)
    acc = np.random.default_rng(2).standard_normal(
        (gj.nv, 12)).astype(np.float32)
    rj = IJ.unload_accumulator(fj, jnp.asarray(acc), gj)
    rt = IT.unload_accumulator(ft, torch.from_numpy(acc), gt)
    for n in ("jfx", "jfy", "jfz"):
        assert_close_rel(getattr(rj, n), getattr(rt, n), 1e-6, 0.0, n)


def test_remote_and_decomposed_raise():
    g = GT.partition_periodic_box(0, 0, 0, 1, 1, 1, 4, 4, 4).with_bc(
        0, fbc=GT.REMOTE)
    f = ST.FieldState.zeros(g, "cpu")
    # a remote face with no rank to take its plane from
    with pytest.raises(ValueError, match="undecomposed"):
        FT.ghost_norm_e(f, g)
    # a decomposed grid runs one process per rank (tests/
    # test_torch_sharded_fields.py); without a mesh it is refused
    sharded = dataclasses.replace(g, topology=(2, 1, 1))
    with pytest.raises(RuntimeError, match="one process per rank"):
        FT.synchronize_jf(f, sharded)
