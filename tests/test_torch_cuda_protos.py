"""The prototype kernels -- block compaction, mailbox copies and the fused
field trio -- against their plain PyTorch versions, on the card.  Every
test here is marked ``gpu`` and skips without a CUDA device (decided inside
the fixture, never at import).  This file imports neither jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_protos.py

Tolerances: compaction, block copy and mailbox bit for bit (pure data
movement, a -0.0 and a NaN included), each one kernel launch a call (the
mailbox into a given ``out=``); the field trio to 1e-6 abs on each of its 9 outputs,
ghost planes included (the prototype's own bound; the kernel rounds every
operation as the plain version does, so 0 is expected)."""

import dataclasses

import numpy as np
import pytest
import torch

import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.compact as C
import vpic_tpu_torch.ops.field_fuse as FF
import vpic_tpu_torch.state as ST
from vpic_tpu_torch.models import harris
from vpic_tpu_torch.ops import _build
from vpic_tpu_torch.scripts import device_kernels

pytestmark = pytest.mark.gpu

KERNELS = (C.KERNEL, C.MAILBOX_KERNEL, FF.KERNEL)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def test_kernels_build_for_sm_90a(cuda):
    _build.build_many(KERNELS)
    for name in KERNELS:
        log = _build.build_log(name)
        spills = [ln for ln in log.splitlines() if "spill stores" in ln]
        assert "sm_90a" in log and spills, name
        assert all("0 bytes spill stores" in ln for ln in spills), name


def _one_launch(fn, kernel):
    """fn() puts nothing on the device but ``kernel``, at most once a call
    (the profiler may miss a launch; the wrapper's count says it ran)."""
    kernels = device_kernels(fn, 10)
    assert len(kernels) == 1 and kernel in next(iter(kernels)), kernels
    assert sum(n for n, _ in kernels.values()) <= 1, kernels


def _unaligned(a: np.ndarray, dev):
    """A contiguous copy of ``a`` on ``dev`` whose data starts 4 bytes
    past a 16-byte boundary."""
    flat = torch.empty(a.size + 1, dtype=torch.float32, device=dev)
    t = flat[1:].view(a.shape)
    t.copy_(torch.as_tensor(a))
    assert t.data_ptr() % 16 == 4
    return t


@pytest.mark.parametrize("rows,block,nb,mask", [
    (9, 4096, 1, "float"), (16, 4096, 8, "float"), (16, 4096, 4, "all"),
    (5, 1000, 3, "bool"), (3, 2048, 2, "none"), (16, 4096, 64, "float"),
    (1, 4096, 2, "bool"), (17, 1000, 3, "float"), (5, 1001, 3, "bool"),
    (5, 1001, 2, "float"), (17, 4096, 64, "bool"), (12, 2048, 128, "float"),
    (16, 4096, 64, "copy"), (3, 1001, 3, "copy"),
    (16, 4096, 2, "copy_unaligned")])
def test_compaction_kernel_matches_plain(cuda, rows, block, nb, mask):
    """Blocks of 1001 lanes read the mask one lane at a time (no 4-lane
    loads); (16, 4096, 64), (17, 4096, 64) and (12, 2048, 128) move 8, 8
    and 1, and 6 rows a thread (the 8-row build), the others 1-4; the copy
    (keep=None) of 3 x 3003 floats ends in a tail that is not a 16-byte
    word, and an unaligned input takes 4-byte words."""
    rng = np.random.default_rng(block + nb)
    pk = rng.normal(size=(rows, nb * block)).astype(np.float32)
    pk[0, 5] = -0.0
    pk[-1, 6] = np.nan
    keep = rng.random(nb * block) > 0.12
    keep[[5, 6]] = True
    keep = {"float": keep.astype(np.float32), "bool": keep,
            "all": np.ones(nb * block, bool),
            "none": np.zeros(nb * block, bool)}.get(mask)
    pk_t = (_unaligned(pk, cuda) if mask == "copy_unaligned"
            else torch.as_tensor(pk, device=cuda))
    keep_t = None if keep is None else torch.as_tensor(keep, device=cuda)
    n0, c0 = C.launches, C.copy_launches
    out, cnt = C.compact_blocks(pk_t, keep_t, block)
    ref, ref_cnt = C.compact_blocks_ref(pk_t, keep_t, block)
    torch.cuda.synchronize()
    copy = keep is None
    assert (C.launches, C.copy_launches) == (n0 + (not copy), c0 + copy)
    assert _same_bits(out, ref) and torch.equal(cnt, ref_cnt)
    if mask in ("all", "copy", "copy_unaligned"):
        assert _same_bits(out, pk_t)
        assert cnt.tolist() == [block] * nb
    _one_launch(lambda: C.compact_blocks(pk_t, keep_t, block),
                "block_copy_kernel" if copy else "compact_kernel")


def test_mailbox_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    nb, M = 96, C.MAILBOX_WIDTH
    big = torch.as_tensor(rng.normal(size=(16, M * nb)).astype(np.float32),
                          device=cuda)
    offs = torch.as_tensor((rng.permutation(nb) * M).astype(np.int32),
                           device=cuda)
    n0 = C.mailbox_launches
    out = C.mailbox(big, offs, M * nb)
    assert C.mailbox_launches == n0 + 1
    assert _same_bits(out, C.mailbox_ref(big, offs, M * nb))
    # into a NaN-filled out= with two more slots than blocks: the covered
    # columns are copied, the others keep their NaN, one launch a call
    nan = lambda: torch.full((16, M * (nb + 2)), float("nan"), device=cuda)
    offs2 = torch.as_tensor((rng.permutation(nb + 2)[:nb] * M)
                            .astype(np.int32), device=cuda)
    out = nan()
    assert C.mailbox(big, offs2, M * (nb + 2), out=out) is out
    assert C.mailbox_launches == n0 + 2
    assert _same_bits(out, C.mailbox_ref(big, offs2, M * (nb + 2),
                                         out=nan()))
    assert int(out.isnan().all(0).sum()) == 2 * M
    _one_launch(lambda: C.mailbox(big, offs2, M * (nb + 2), out=out),
                "mailbox_kernel")
    # blocks at a negative offset, past the end or at an offset that is
    # not a multiple of 4 are skipped; a 4-aligned offset is copied
    big = torch.as_tensor(rng.normal(size=(3, 5 * M)).astype(np.float32),
                          device=cuda)
    offs = torch.tensor([2 * M, -M, 4 * M + 4, 3, 4], dtype=torch.int32,
                        device=cuda)
    out = C.mailbox(big, offs, 5 * M)
    assert _same_bits(out, C.mailbox_ref(big, offs, 5 * M))
    assert _same_bits(out[:, 4:4 + M], big[:, 4 * M:])
    assert not out[:, M + 4:2 * M].any() and not out[:, 3 * M:].any()
    out = torch.full((3, 5 * M), float("nan"), device=cuda)
    C.mailbox(big, offs, 5 * M, out=out)
    assert _same_bits(out, C.mailbox_ref(
        big, offs, 5 * M, out=torch.full_like(out, float("nan"))))
    assert out[:, M + 4:2 * M].isnan().all() and out[:, 3 * M:].isnan().all()
    assert _same_bits(out[:, 2 * M:3 * M], big[:, :M])


def _walled_fields(fbc, device, seed=3):
    """Random fields on a 5 x 4 x 3 grid with the given field faces and a
    conducting, non-unit material (0-d coefficients)."""
    g = GT.partition_periodic_box(0, 0, 0, 1.0, 0.8, 0.6, 5, 4, 3, dt=0.05,
                                  cvac=1.0, eps0=1.0)
    for face, bc in enumerate(fbc):
        g = g.with_bc(face, fbc=bc)
    rng = np.random.default_rng(seed)
    f = ST.FieldState(**{n: torch.as_tensor(
        rng.standard_normal(g.shape).astype(np.float32), device=device)
        for n in ST.FIELD_NAMES})
    vals = dict(decayx=0.91, decayy=0.93, decayz=0.95, drivex=0.97,
                drivey=0.96, drivez=0.94, rmux=0.8, rmuy=0.85, rmuz=0.9,
                nonconductive=1.0, epsx=1.2, epsy=1.1, epsz=1.3)
    m = ST.MaterialCoeffs(**{k: torch.tensor(v, device=device)
                             for k, v in vals.items()})
    return g, f, m, 0.01


def _harris_fields(device, nz):
    three = nz > 1
    p = harris.HarrisParams(nx=16, ny=16, nz=nz, nppc=2 if three else 4,
                            Lx=8.0, Ly=8.0, Lz=8.0)
    sim = harris.build(p, device=device)
    f = sim.initialize().fields
    return sim.grid, f, sim._material_coeffs(), sim.damp


_P, _S, _Y, _M = GT.PEC, GT.SYMMETRIC, GT.PERIODIC, GT.PMC
CASES = {
    "harris2d": lambda dev: _harris_fields(dev, 1),
    "harris3d": lambda dev: _harris_fields(dev, 16),
    "pec3d": lambda dev: _walled_fields((_P, _Y, _Y, _P, _Y, _Y), dev),
    "walls3d": lambda dev: _walled_fields((_Y, _S, _P, _Y, _M, _P), dev),
    "pmc_x": lambda dev: _walled_fields((_M, _P, _S, _S, _Y, _Y), dev),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_field_beb_kernel_matches_plain(cuda, case):
    g, f, m, damp = CASES[case](cuda)
    clone = lambda: dataclasses.replace(
        f, **{n: getattr(f, n).clone() for n in ST.FIELD_NAMES})
    fk, fr = clone(), clone()
    beb = FF.make_beb(g, m, damp)
    n0 = FF.launches
    out = beb(fk)
    FF.beb_ref(fr, g, m, damp)
    torch.cuda.synchronize()
    assert out is fk and FF.launches == n0 + 1
    for n in FF.FIELDS:
        err = float((getattr(fk, n) - getattr(fr, n)).abs().max())
        assert err <= 1e-6, f"{n}: max abs err {err}"
    assert torch.equal(fk.jfx, f.jfx)


def test_failed_launch_raises(cuda, monkeypatch):
    """A launch CUDA refuses (2048 threads a block) raises, and the
    next launch runs."""
    g, f, m, damp = CASES["pec3d"](cuda)
    beb = FF.make_beb(g, m, damp)
    big = torch.zeros((16, 256), device=cuda)
    offs = torch.tensor([0, 128], dtype=torch.int32, device=cuda)
    monkeypatch.setattr(FF, "THREADS", 2048)
    monkeypatch.setattr(C, "THREADS", 2048)
    with pytest.raises(RuntimeError, match="launch failed"):
        beb(f)
    with pytest.raises(RuntimeError, match="launch failed"):
        C.mailbox(big, offs, 256)
    monkeypatch.undo()
    beb(f)
    C.mailbox(big, offs, 256)
    torch.cuda.synchronize()


def test_failed_build_raises(cuda, monkeypatch, tmp_path):
    """No fallback: where the kernels cannot be built, CUDA tensors raise."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "nvcc", lambda: "false")
    pk = torch.zeros((2, 1024), device=cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        C.compact_blocks(pk, torch.ones(1024, dtype=torch.bool,
                                        device=cuda), 1024)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        C.mailbox(pk, torch.zeros(1, dtype=torch.int32, device=cuda), 1024)
    g, f, m, damp = CASES["pec3d"](cuda)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        FF.make_beb(g, m, damp)(f)
