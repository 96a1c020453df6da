"""Port field solver, cleaners and energies against vpic_tpu: each op runs
on the same random numpy fields in both packages and every output agrees
to 1e-6 max|a| (float32; the ops run the same arithmetic in the same
order, the bound covers fused multiply-add and summation order).  Ghost
fills, local BCs, face syncs and the interpolator/accumulator are in
test_torch_field_bcs.py."""

import pytest
import torch

import vpic_tpu.ops.fields as FJ
import vpic_tpu_torch.ops.fields as FT
import vpic_tpu_torch.state as ST

from torch_parity import assert_close_rel, check_field_op, field_pair

torch.set_num_threads(2)

# op name -> (jax call, torch call), each fn(fields, grid, material)
OPS = {
    "advance_b": (lambda f, g, m: FJ.advance_b(f, g, 0.5),
                  lambda f, g, m: FT.advance_b(f, g, 0.5)),
    "advance_e": (lambda f, g, m: FJ.advance_e(f, g, m, 0.001),
                  lambda f, g, m: FT.advance_e(f, g, m, 0.001)),
    "compute_curl_b": (lambda f, g, m: FJ.compute_curl_b(f, g, m),
                       lambda f, g, m: FT.compute_curl_b(f, g, m)),
    "compute_div_e_err": (lambda f, g, m: FJ.compute_div_e_err(f, g, m),
                          lambda f, g, m: FT.compute_div_e_err(f, g, m)),
    "clean_div_e": (lambda f, g, m: FJ.clean_div_e(f, g, m),
                    lambda f, g, m: FT.clean_div_e(f, g, m)),
    "compute_div_b_err": (lambda f, g, m: FJ.compute_div_b_err(f, g),
                          lambda f, g, m: FT.compute_div_b_err(f, g)),
    "clean_div_b": (lambda f, g, m: FJ.clean_div_b(f, g),
                    lambda f, g, m: FT.clean_div_b(f, g)),
    "compute_rhob": (lambda f, g, m: FJ.compute_rhob(f, g, m),
                     lambda f, g, m: FT.compute_rhob(f, g, m)),
    "compute_rms_div_e_err": (lambda f, g, m: FJ.compute_rms_div_e_err(f, g),
                              lambda f, g, m: FT.compute_rms_div_e_err(f, g)),
    "compute_rms_div_b_err": (lambda f, g, m: FJ.compute_rms_div_b_err(f, g),
                              lambda f, g, m: FT.compute_rms_div_b_err(f, g)),
    "energy_f": (lambda f, g, m: FJ.energy_f(f, g, m),
                 lambda f, g, m: FT.energy_f(f, g, m)),
}


# the periodic grid's ghost fills and syncs are covered in
# test_torch_field_bcs.py; the stencils themselves see no BC
@pytest.mark.parametrize("grid", ["harris2d", "mixed3d"])
@pytest.mark.parametrize("op", sorted(OPS))
def test_field_op_matches_jax(op, grid):
    check_field_op(*OPS[op], grid)


def test_sequence_of_ops_in_place():
    """The torch ops mutate in place: a chain of them must still match the
    functional JAX chain (no op reads a value another already overwrote)."""
    (gj, fj, mj), (gt, ft, mt) = field_pair("harris2d", seed=3)
    chain = [OPS[n] for n in ("advance_b", "advance_e", "advance_b",
                              "compute_div_e_err", "clean_div_e",
                              "compute_div_b_err", "clean_div_b")]
    chain.append((lambda f, g, m: FJ.synchronize_tang_e_norm_b(f, g)[0],
                  lambda f, g, m: FT.synchronize_tang_e_norm_b(f, g)[0]))
    for fn_j, fn_t in chain:
        fj = fn_j(fj, gj, mj)
        assert fn_t(ft, gt, mt) is ft
    for n in ST.FIELD_NAMES:
        assert_close_rel(getattr(fj, n), getattr(ft, n), 1e-6, 0.0, n)
