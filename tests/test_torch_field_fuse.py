"""The port's fused field trio (ops/field_fuse) on the CPU against the JAX
prototype kernel scripts/field_fuse_proto.make_beb_kernel, run in Pallas
interpret mode: the 9 outputs (E, cB, TCA with their ghost planes) to 1e-6
abs, the prototype's own bound, on the 16^2 x 4 ppc harris fields and on
random fields of small 3-D grids with pec, symmetric and pmc walls.  On the
CPU the port's ``beb`` runs its plain version; the kernel is held against
that version on the card (tests/test_torch_cuda_protos.py)."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.field_fuse as FF
import vpic_tpu_torch.ops.fields as FT
import vpic_tpu_torch.state as ST
from vpic_tpu_torch.scripts import field_fuse_proto as proto_torch

from torch_parity import build_pair, field_pair

torch.set_num_threads(2)

TOL = 1e-6
ROOT = Path(__file__).resolve().parent.parent


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_jax", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


proto_jax = _load_script("field_fuse_proto")


def _host_floats(m):
    """0-d coefficients as Python floats, as the prototype's main does."""
    return dataclasses.replace(m, **{
        f.name: float(getattr(m, f.name)) for f in dataclasses.fields(m)})


def _compare(fj, gj, mj, ft, gt, mt, damp):
    out_j = proto_jax.make_beb_kernel(gj, _host_floats(mj), damp, fj)(fj)
    out_t = FF.make_beb(gt, mt, damp)(ft)
    for n in FF.OUTPUTS:
        a = np.asarray(jax.device_get(getattr(out_j, n)))
        b = getattr(out_t, n).numpy()
        err = np.abs(a - b).max()
        assert err < TOL, f"{n}: max abs err {err}"


def test_beb_matches_jax_prototype_on_harris():
    sim_j, sim_t = build_pair()
    fj = sim_j.initialize().fields
    mj = sim_j._local_material_coeffs(sim_j._material_coeffs())
    ft = ST.FieldState(**{n: torch.from_numpy(np.array(getattr(fj, n)))
                          for n in ST.FIELD_NAMES})
    assert sim_j.damp == sim_t.damp > 0
    _compare(fj, sim_j.grid, mj, ft, sim_t.grid, sim_t._material_coeffs(),
             sim_t.damp)


@pytest.mark.parametrize("grid", ["pec3d", "walls3d"])
def test_beb_matches_jax_prototype_on_walled_grids(grid):
    (gj, fj, mj), (gt, ft, mt) = field_pair(grid, seed=3)
    _compare(fj, gj, mj, ft, gt, mt, 0.01)


@pytest.mark.parametrize("grid", ["harris2d", "pec3d", "walls3d"])
def test_ghost_points_from_their_sources_match_ghost_tang_b(grid):
    """The kernel's ghost phase, written out in numpy: every tangential cB
    ghost point maps all its ghost coordinates to their source planes at
    once (wrap, mirror, negated mirror).  It must give ghost_tang_b's
    plane-by-plane fill bit for bit, corners and edges included."""
    _, (g, f, _) = field_pair(grid, seed=4)
    n = (g.nx, g.ny, g.nz)
    codes = [FF._GHOST[bc] for bc in g.field_bc]
    want = {}
    for c, name in enumerate(("cbx", "cby", "cbz")):
        a = getattr(f, name).numpy()
        zyx = np.indices(a.shape)
        q = [zyx[2], zyx[1], zyx[0]]
        src = list(q)
        ghost = np.zeros(a.shape, bool)
        negate = np.zeros(a.shape, bool)
        for ax in range(3):
            if ax == c:
                continue
            lo, hi = q[ax] == 0, q[ax] == n[ax] + 1
            clo, chi = codes[ax], codes[ax + 3]
            src[ax] = np.where(lo, n[ax] if clo == 0 else 1,
                               np.where(hi, 1 if chi == 0 else n[ax], q[ax]))
            ghost |= lo | hi
            negate ^= (lo & (clo < 0)) | (hi & (chi < 0))
        val = a[src[2], src[1], src[0]]
        want[name] = np.where(ghost, np.where(negate, -val, val), a)
    FT.ghost_tang_b(f, g)
    for name, w in want.items():
        assert np.array_equal(getattr(f, name).numpy().view(np.int32),
                              w.view(np.int32)), name


def test_beb_refuses_what_the_kernel_does_not_cover():
    _, (g, _, m) = field_pair("pec3d")
    assert FF.supports_beb(g, m)
    absorbing = g.with_bc(2, fbc=GT.ABSORB_FIELDS)
    remote = g.with_bc(1, fbc=GT.REMOTE)
    sharded = dataclasses.replace(g, topology=(2, 1, 1))
    mesh = dataclasses.replace(m, rmux=torch.ones(g.shape))
    for gg, mm in ((absorbing, m), (remote, m), (sharded, m), (g, mesh)):
        assert not FF.supports_beb(gg, mm)
        with pytest.raises(NotImplementedError):
            FF.make_beb(gg, mm, 0.0)


def test_beb_runs_in_place_on_the_cpu():
    _, (g, f, m) = field_pair("walls3d", seed=5)
    ref = FF.beb_ref(ST.FieldState(**{n: getattr(f, n).clone()
                                      for n in ST.FIELD_NAMES}), g, m, 0.02)
    ex = f.ex
    out = FF.make_beb(g, m, 0.02)(f)
    assert out is f and out.ex is ex
    for n in FF.FIELDS:
        assert torch.equal(getattr(out, n), getattr(ref, n)), n
    with pytest.raises(ValueError):
        FF.make_beb(g, m, 0.0)(f.replace(ex=f.ex.to("meta")))


def test_field_fuse_proto_main_on_the_cpu():
    res = proto_torch.main(["--cpu", "--nx", "16", "--ny", "16"])
    assert res["finite"] and res["shape"] == [3, 18, 18]


def test_field_fuse_proto_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script runs the kernel")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        proto_torch.main(["--nx", "16", "--ny", "16"])

