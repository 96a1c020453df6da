"""The residency plan's kernels (csrc/res_plan.cu, residency.plan on CUDA
tensors) against its plain version (residency.plan_ref) on the card, on
the same CUDA tensors.  Every test here is marked ``gpu`` and skips without
a CUDA device (decided inside the fixture, never at import).  This file
imports neither jax nor vpic_tpu:

    python -m pytest -m gpu --noconftest tests/test_torch_cuda_plan.py

The plan is integer routing and data movement, so every comparison is bit
for bit: the compact rows up to the routed total (the kernel leaves the
rows past it unwritten; the merge never reads them), the compact valid
marks, starts_j, a_j, stats, overflow, misplaced and the rebuild bool."""

import pytest
import torch

import vpic_tpu_torch.ops.residency as RES
from vpic_tpu_torch.models import harris

import plan_cases as PC
from test_torch_cuda3d import (_assert_merged_equal, _beam_deck, _clone,
                               _push_both, _sorted_state)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _plans(args, kw):
    """The kernel's plan (four launches) and the plain version's."""
    before = RES.plan_launches
    k = RES.plan(*args, **kw)
    assert RES.plan_launches == before + RES.PLAN_LAUNCHES
    r = RES.plan_ref(*args, **kw)
    torch.cuda.synchronize()
    PC.assert_plans_equal(k, r)
    return k, r


@pytest.mark.parametrize("case", PC.CASES)
def test_plan_kernel_matches_plain(cuda, case):
    """PLAN_CASES (one and two species, an unusable partial tail block,
    crafted and random free space), three species with tiles of several
    blocks, a stray lane, a roomy layout, a routed total past max_routed
    and leavers past the outbox cap."""
    args, kw = PC.plan_inputs(case, cuda)
    k, _ = _plans(args, kw)
    if case == "stray":
        assert bool(k.misplaced) and bool(k.rebuild)
    if case == "roomy":
        assert not bool(k.rebuild) and int(k.a_j.sum()) > 0
    if case == "over_maxin":
        assert bool(k.overflow) and int(k.stats[0]) > k.compact.vox.shape[0]
    if case == "outbox_cap":
        assert bool(k.rebuild) and not bool(k.overflow)


@pytest.mark.parametrize("case", sorted(PC.CAUSE_OF) + ["roomy"])
def test_plan_kernel_counts_rebuckets_by_cause(cuda, case):
    """The plan kernel adds a rebucket to the count of its cause, as the
    plain version's flags give it, and writes the counts through to the
    host copy residency.rebuckets_by_cause reads: an outbox past its cap,
    an exchange overflow, a stray alone, and a merge (no count)."""
    args, kw = PC.plan_inputs(case, cuda)
    torch.cuda.synchronize()
    before = RES.rebuckets_by_cause()
    k, r = _plans(args, kw)
    after = RES.rebuckets_by_cause()
    want = PC.cause(r, args[3])
    assert want == PC.CAUSE_OF.get(case)
    assert {c: after[c] - before[c] for c in RES.CAUSES} == \
        {c: int(c == want) for c in RES.CAUSES}
    dev, _ = RES._cause_counters(args[2].vox.device)
    cpu = RES._cpu_causes.tolist()
    assert dev.tolist() == [after[c] - cpu[n]
                            for n, c in enumerate(RES.CAUSES)]


def _push_and_plan(sim):
    g, species, homes, fcoef, qms = _sorted_state(sim)
    (sk, _, em, obx, ores, _), _ = _push_both(g, species, homes, fcoef, qms)
    _, spid, usable = RES.static_layout([sp.capacity for sp in sk])
    args = (sk, em, obx, ores, homes, spid, usable, g)
    return args, _plans(args, {})


@pytest.mark.parametrize("nppc", [4, 16])
def test_plan_kernel_on_harris3d(cuda, nppc):
    """The states of test_kernels_match_plain_on_harris3d: the plans are
    equal, and the merge on the kernel plan's outputs equals the merge on
    the plain plan's, in every lane."""
    sim = harris.build(harris.HarrisParams(
        nx=16, ny=16, nz=16, nppc=nppc, Lx=8.0, Ly=8.0, Lz=8.0,
        headroom=6.0 if nppc == 4 else 3.0), device=cuda)
    (sk, em, *_), (k, r) = _push_and_plan(sim)
    assert not bool(k.overflow) and int(k.a_j.sum()) > 0
    ka, kb = _clone(sk), _clone(sk)
    mk = RES.merge_p(ka, em, k.compact, k.starts_j, k.a_j, ka)
    mr = RES.merge_p(kb, em, r.compact, r.starts_j, r.a_j, kb)
    torch.cuda.synchronize()
    _assert_merged_equal(mk, mr)


def test_plan_kernel_on_outbox_overflow(cuda):
    """The beam deck: leavers past the outbox cap (ores > 0) make the
    kernel's rebuild bool True, as the plain version's."""
    args, (k, _) = _push_and_plan(_beam_deck(cuda))
    ores = args[3]
    assert int(ores) > 0 and bool(k.rebuild)


def test_plan_kernel_refuses_bad_inputs(cuda):
    """A tensor on another device, a wrong dtype or a misaligned voxel
    array raises before any launch."""
    args, kw = PC.plan_inputs("random", cuda)
    sps, emits, obx, ores, homes, spid, usable, g = args
    launched = RES.plan_launches
    with pytest.raises(ValueError):
        RES.plan(sps, emits, obx._replace(vox=obx.vox.cpu()), ores, homes,
                 spid, usable, g, **kw)
    with pytest.raises(ValueError):
        RES.plan(sps, emits, obx, ores.cpu(), homes, spid, usable, g, **kw)
    with pytest.raises(TypeError):
        RES.plan(sps, emits, obx, ores, [h.long() for h in homes], spid,
                 usable, g, **kw)
    N = sps[1].capacity
    shifted = torch.empty(N + 1, dtype=torch.int32, device=cuda)[1:]
    shifted.copy_(sps[1].i)
    with pytest.raises(ValueError):              # not 16-byte aligned
        RES.plan([sps[0], sps[1].replace(i=shifted)], emits, obx, ores,
                 homes, spid, usable, g, **kw)
    assert RES.plan_launches == launched
