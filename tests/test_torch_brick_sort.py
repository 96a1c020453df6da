"""The port's quantized brick sort against vpic_tpu/ops/pallas_push3d.py,
bit for bit: the sorted lanes and the block -> home brick map, with and
without extent and slack, the tight-packing fallback, and a capacity that
is not a multiple of 1024; and the brick geometry helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu.grid as GJ
import vpic_tpu.ops.pallas_push3d as PP3
import vpic_tpu.state as SJ
import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.fused_push3d as FP3
import vpic_tpu_torch.state as ST

from torch_parity import np_

torch.set_num_threads(2)

FIELDS = ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live")


def _species(rng, g, N, n_live, packed=False):
    """Random lanes: n_live live lanes on interior voxels (scattered over
    the capacity unless ``packed``), dead lanes with voxel 0."""
    live = np.zeros(N, bool)
    idx = np.arange(n_live) if packed else rng.choice(N, n_live, False)
    live[idx] = True
    x = rng.integers(1, g.nx + 1, N)
    y = rng.integers(1, g.ny + 1, N)
    z = rng.integers(1, g.nz + 1, N)
    vox = np.where(live, x + g.NX * (y + g.NY * z), 0).astype(np.int32)
    f = lambda: rng.uniform(-1, 1, N).astype(np.float32)
    arrs = dict(dx=f(), dy=f(), dz=f(), i=vox, ux=f(), uy=f(), uz=f(),
                w=rng.uniform(0.5, 1.5, N).astype(np.float32), live=live,
                np=np.int32(n_live))
    sj = SJ.SpeciesState(**{k: jnp.asarray(v) for k, v in arrs.items()})
    st = ST.SpeciesState(**{k: torch.as_tensor(np.asarray(v))
                            for k, v in arrs.items()})
    return sj, st


def _grids(n=16, nz=16):
    kw = dict(dt=0.05, cvac=1.0, eps0=1.0)
    return (GJ.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, nz, **kw),
            GT.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, nz, **kw))


@pytest.mark.parametrize("n,nz", [(16, 16), (32, 16), (12, 16), (16, 1),
                                  (32, 1)])
def test_geometry_matches(n, nz):
    gj, gt = _grids(n, nz)
    assert FP3.chart_dims(gt) == PP3.chart_dims(gj)
    assert FP3.supports3d(gt) == PP3.supports3d(gj)
    if FP3.supports3d(gt):
        assert FP3._nb(gt) == PP3._nb(gj)
        assert FP3.nbricks(gt) == PP3.nbricks(gj)


def test_brick_of_matches():
    gj, gt = _grids(32, 16)
    rng = np.random.default_rng(0)
    vox = rng.integers(0, gt.nv, 5000).astype(np.int32)
    assert np.array_equal(np.asarray(PP3.brick_of(jnp.asarray(vox), gj)),
                          np_(FP3.brick_of(torch.as_tensor(vox), gt)))


# (capacity, live lanes, extent, slack): extent and slack on and off, the
# tight-packing fallback (the quantized layout does not fit) and a capacity
# that is not a multiple of 1024 (test_pallas3d.py:257)
SORT_CASES = [(24576, 5000, 0, 0), (24576, 5000, 5000, 0),
              (24576, 5000, 5000, 1), (24000, 5000, 0, 0),
              (24000, 5000, 5000, 0), (7168, 6000, 0, 0),
              (7168, 6000, 6000, 0), (24576, 5000, 5000, 2)]


@pytest.mark.parametrize("N,n_live,extent,slack", SORT_CASES)
def test_brick_sort_p_home_bit_equal(N, n_live, extent, slack):
    gj, gt = _grids()
    rng = np.random.default_rng(N + n_live + extent + slack)
    # an extent promises the live lanes lie inside it
    sj, st = _species(rng, gt, N, n_live, packed=bool(extent))
    out_j, home_j = PP3.brick_sort_p_home(sj, gj, extent=extent,
                                          slack=slack)
    out_t, home_t = FP3.brick_sort_p_home(st, gt, extent=extent,
                                          slack=slack)
    assert home_t.dtype == torch.int32
    assert np.array_equal(np.asarray(home_j), np_(home_t))
    for n in FIELDS + ("np",):
        a, b = np.asarray(getattr(out_j, n)), np_(getattr(out_t, n))
        assert a.dtype == b.dtype and np.array_equal(a, b), n
    assert int(out_t.live.sum()) == n_live


def test_tight_fallback_is_taken():
    """7168 slots cannot hold 8 bricks of ~750 lanes at 1024 slots each:
    the fallback packs tight, and both packages agree on that too."""
    gj, gt = _grids()
    sj, st = _species(np.random.default_rng(3), gt, 7168, 6000)
    out_t, home_t = FP3.brick_sort_p_home(st, gt)
    assert out_t.live[:6000].all() and not out_t.live[6000:].any()
    assert np.array_equal(np.asarray(PP3.brick_sort_p_home(sj, gj)[1]),
                          np_(home_t))


def test_brick_sort_p_matches():
    gj, gt = _grids()
    sj, st = _species(np.random.default_rng(4), gt, 24000, 5000, True)
    a, b = PP3.brick_sort_p(sj, gj, extent=5000), FP3.brick_sort_p(
        st, gt, extent=5000)
    for n in FIELDS:
        assert np.array_equal(np.asarray(getattr(a, n)), np_(getattr(b, n)))


def test_check3d_refuses():
    gj, gt = _grids(12, 16)
    with pytest.raises(NotImplementedError):
        FP3.check3d(gt)
    _, gt = _grids()
    with pytest.raises(NotImplementedError):
        FP3.check3d(gt.with_bc(0, pbc=GT.P_REMOTE))
    FP3.check3d(gt)
    FP3.check3d(gt.with_bc(0, pbc=GT.ABSORB_PARTICLES))   # a wall face
