"""The port's block compaction and mailbox (ops/compact) on the CPU against
the JAX residency prototypes' Pallas kernels, run in interpret mode, bit for
bit: scripts/residency_proto.py's compact_block and mailbox on the script's
seed-0 data, and the grid kernels of scripts/residency_grid_bench.py and
residency_grid_bench2.py.  Those two scripts run their benchmarks when
imported, so only their imports, constants and ``make`` are loaded (through
``ast``), with NB = 2 blocks.  On the CPU the port's wrappers run their
plain versions; the kernels are held against them on the card
(tests/test_torch_cuda_protos.py)."""

import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vpic_tpu_torch.ops.compact as C
from vpic_tpu_torch.scripts import residency_grid_bench as grid_torch
from vpic_tpu_torch.scripts import residency_proto as proto_torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
P = proto_torch.P
S = 512             # the prototype's segment size and removal cap


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_jax", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_make(name, nb=2):
    """``make`` of a grid-bench script with its imports and constants only
    (the rest of the file is its benchmark), NB set to ``nb``."""
    path = ROOT / "scripts" / f"{name}.py"
    tree = ast.parse(path.read_text(), filename=str(path))

    def constant(node):
        v = node.value
        elts = v.elts if isinstance(v, ast.Tuple) else [v]
        return all(isinstance(e, ast.Constant) for e in elts)

    body = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(n, ast.Assign) and constant(n))]
    ns = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    assert (ns["P"], ns["S"]) == (P, S)
    ns["NB"] = nb
    return ns["make"]


proto_jax = _load_script("residency_proto")


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _both_compact(pk, keep):
    """(JAX compact_block, port compact_blocks) of one (9, P) block."""
    out_j, cnt_j = proto_jax.compact_block(jnp.asarray(pk),
                                           jnp.asarray(keep[None, :]))
    out_t, cnt_t = C.compact_blocks(torch.from_numpy(pk),
                                    torch.from_numpy(keep), P)
    return (np.asarray(out_j), int(np.asarray(cnt_j)[0, 0]),
            out_t.numpy(), cnt_t.numpy())


def test_compaction_matches_proto_on_its_seed0_data():
    pk, keep, _, _ = proto_torch.inputs()
    out_j, cnt_j, out_t, cnt_t = _both_compact(pk, keep)
    assert cnt_t.tolist() == [cnt_j] == [int(keep.sum())]
    assert np.array_equal(_bits(out_j), _bits(out_t))


@pytest.mark.parametrize("spread", [False, True])
def test_compaction_matches_proto_at_its_window_cap(spread):
    """Exactly S removals ahead of the lane that ends output segment 1
    (input lane 3S - 1 lands at 2S - 1, the far end of its 2S window): the
    TPU kernel is still exact there, and both agree."""
    rng = np.random.default_rng(7)
    pk = rng.normal(size=(9, P)).astype(np.float32)
    keep = np.ones(P, np.float32)
    if spread:
        keep[rng.choice(3 * S - 1, S, replace=False)] = 0.0
    else:
        keep[S + 88:2 * S + 88] = 0.0
    assert keep[:3 * S - 1].sum() == 2 * S - 1 and keep[3 * S - 1] == 1
    out_j, cnt_j, out_t, cnt_t = _both_compact(pk, keep)
    assert cnt_t.tolist() == [cnt_j] == [P - S]
    assert np.array_equal(_bits(out_j), _bits(out_t))
    assert np.array_equal(out_t[:, 2 * S - 1], pk[:, 3 * S - 1])


def test_past_the_window_cap_only_the_port_is_exact():
    """S + 1 removals ahead of input lane 3S, which belongs at output lane
    2S - 1: outside its 2S window, the TPU kernel leaves a zero there; the
    port computes the exact stable compaction (a difference in domain: the
    residency path caps removals so the TPU kernel never sees this)."""
    rng = np.random.default_rng(8)
    pk = rng.normal(size=(9, P)).astype(np.float32)
    keep = np.ones(P, np.float32)
    keep[S:2 * S + 1] = 0.0
    out_j, cnt_j, out_t, cnt_t = _both_compact(pk, keep)
    assert cnt_t.tolist() == [cnt_j]
    want, _ = proto_torch.compact_np(pk, keep, P)
    assert np.array_equal(out_t, want)
    assert np.array_equal(out_t[:, 2 * S - 1], pk[:, 3 * S])
    assert not out_j[:, 2 * S - 1].any()


def test_mailbox_matches_proto_at_8_blocks():
    rng = np.random.default_rng(0)
    nb, M = 8, C.MAILBOX_WIDTH
    big = rng.normal(size=(16, M * nb)).astype(np.float32)
    offs = (rng.permutation(nb) * M).astype(np.int32)
    out_j = proto_jax.mailbox(jnp.asarray(big), jnp.asarray(offs), nb, M * nb)
    out_t = C.mailbox(torch.from_numpy(big), torch.from_numpy(offs), M * nb)
    assert np.array_equal(_bits(out_j), _bits(out_t))
    assert np.array_equal(out_t.numpy(),
                          proto_torch.mailbox_np(big, offs, M * nb))


def test_mailbox_out_matches_proto_and_keeps_the_rest():
    """Into a NaN-filled ``out=`` (8 blocks in 10 slots): the covered
    columns are the JAX mailbox's, bit for bit, and the two uncovered
    slots keep the sentinel."""
    rng = np.random.default_rng(5)
    nb, M, slots = 8, C.MAILBOX_WIDTH, 10
    n_out = M * slots
    big = rng.normal(size=(16, M * nb)).astype(np.float32)
    offs = (rng.permutation(slots)[:nb] * M).astype(np.int32)
    out_j = np.asarray(proto_jax.mailbox(jnp.asarray(big), jnp.asarray(offs),
                                         nb, n_out))
    out = torch.full((16, n_out), float("nan"))
    got = C.mailbox_ref(torch.from_numpy(big), torch.from_numpy(offs), n_out,
                        out=out)
    assert got is out
    covered = np.zeros(n_out, bool)
    for o in offs:
        covered[o:o + M] = True
    assert covered.sum() == nb * M
    assert np.array_equal(_bits(out_j[:, covered]),
                          _bits(out.numpy()[:, covered]))
    assert np.isnan(out.numpy()[:, ~covered]).all()
    want = proto_torch.mailbox_np(big, offs, n_out, float("nan"))
    assert np.array_equal(_bits(want), _bits(out.numpy()))
    # the wrapper on CPU tensors is the plain version, out= included
    out2 = torch.full((16, n_out), float("nan"))
    C.mailbox(torch.from_numpy(big), torch.from_numpy(offs), n_out, out=out2)
    assert np.array_equal(_bits(out2.numpy()), _bits(want))


def _grid_inputs(nb=2):
    pk, keep = grid_torch.inputs(nb)
    return pk, keep, jnp.asarray(pk), jnp.asarray(keep[None, :])


@pytest.mark.parametrize("script,variant", [
    ("residency_grid_bench", True), ("residency_grid_bench", False),
    ("residency_grid_bench2", "highest"), ("residency_grid_bench2", "split4"),
    ("residency_grid_bench2", "copy")])
def test_grid_kernels_match_compact_blocks(script, variant):
    """Every variant of both grid benches is compact_blocks: the copies
    without a mask (keep=None), the compactions (plain f32,
    HIGHEST-precision and four-pass bf16 one-hot dots) with the removal
    mask; all bit for bit."""
    pk, keep, pk_j, keep_j = _grid_inputs()
    out_j = np.asarray(jax.jit(_load_make(script)(variant))(pk_j, keep_j))
    copy = variant in (False, "copy")
    out_t, cnt = C.compact_blocks(torch.from_numpy(pk),
                                  None if copy else torch.from_numpy(keep), P)
    assert np.array_equal(_bits(out_j), _bits(out_t.numpy()))
    if copy:
        assert np.array_equal(_bits(out_t.numpy()), _bits(pk))
        assert cnt.tolist() == [P, P]
    else:
        assert cnt.tolist() == [int(keep[:P].sum()), int(keep[P:].sum())]
    assert cnt.dtype == torch.int32


@pytest.mark.parametrize("block", [1000, 4096])
@pytest.mark.parametrize("rows", [1, 5, 9, 16])
def test_compact_plan_serves_every_lane_and_row_once(block, rows):
    """CUDA block (b, c, g) of the plan serves lanes [1024 c, 1024 (c + 1))
    and rows [per g, per (g + 1)) of lane block b, cut at the ends: every
    (block, lane, row) exactly once, no CUDA block idle, at most MAX_ROWS
    rows a thread; at (16, 64 x 4096) on 132 SMs the grid is at least two
    waves."""
    for nb in (1, 3, 64):
        plan = C.compact_plan(rows, block, nb, 132)
        nbg, chunks, groups = plan.grid
        per = plan.rows_per_group
        assert nbg == nb and 1 <= per <= C.MAX_ROWS
        served = np.zeros((nb, block, rows), np.int32)
        for b in range(nb):
            for c in range(chunks):
                for g in range(groups):
                    lanes = slice(C.CHUNK * c, min(C.CHUNK * (c + 1), block))
                    rws = slice(per * g, min(per * (g + 1), rows))
                    assert lanes.start < lanes.stop and rws.start < rws.stop
                    served[b, lanes, rws] += 1
        assert (served == 1).all()
    big = C.compact_plan(rows, block, 64 * 4096 // block, 132)
    if (rows, block) == (16, 4096):
        assert big.grid == (64, 4, 2) and np.prod(big.grid) >= 2 * 132
    with pytest.raises(ValueError):
        C.compact_plan(0, block, 1, 132)


def test_plain_compaction_moves_bits_and_any_block_size():
    """A -0.0 and a NaN move unchanged, bool and float masks agree, and a
    block that is not a multiple of 1024 lanes compacts as numpy does."""
    rng = np.random.default_rng(3)
    block, nb = 1000, 3
    pk = rng.normal(size=(5, block * nb)).astype(np.float32)
    pk[0, 10] = -0.0
    pk[1, 11] = np.nan
    keep = rng.random(block * nb) > 0.3
    keep[[10, 11]] = True
    keep[block:2 * block] = False               # an empty block
    want, want_cnt = proto_torch.compact_np(pk, keep, block)
    for mask in (torch.from_numpy(keep), torch.from_numpy(keep).float()):
        out, cnt = C.compact_blocks(torch.from_numpy(pk), mask, block)
        assert np.array_equal(_bits(out.numpy()), _bits(want))
        assert cnt.tolist() == want_cnt.tolist() and cnt[1] == 0
        assert cnt.dtype == torch.int32


def test_plain_mailbox_skips_blocks_that_do_not_fit():
    """Blocks at a negative offset, past the end or at an offset that is
    not a multiple of 4 are skipped; a 4-aligned offset is copied."""
    rng = np.random.default_rng(4)
    M = C.MAILBOX_WIDTH
    big = rng.normal(size=(3, 5 * M)).astype(np.float32)
    offs = np.array([2 * M, -M, 4 * M + 4, 3, 4], np.int32)
    out = C.mailbox(torch.from_numpy(big), torch.from_numpy(offs), 5 * M)
    want = np.zeros((3, 5 * M), np.float32)
    want[:, 2 * M:3 * M] = big[:, :M]
    want[:, 4:4 + M] = big[:, 4 * M:]
    assert np.array_equal(out.numpy(), want)


def test_wrappers_reject_bad_inputs():
    pk = torch.zeros((2, 2 * P))
    keep = torch.ones(2 * P, dtype=torch.bool)
    with pytest.raises(ValueError):
        C.compact_blocks(pk, keep, 3000)
    with pytest.raises(ValueError):
        C.compact_blocks(pk, keep[:-1], P)
    with pytest.raises(TypeError):
        C.compact_blocks(pk.double(), keep, P)
    with pytest.raises(TypeError):
        C.compact_blocks(pk, keep.int(), P)
    with pytest.raises(ValueError):
        C.compact_blocks(pk.to("meta"), keep.to("meta"), P)
    offs = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        C.mailbox(pk[:, :256], offs, 512)
    with pytest.raises(TypeError):
        C.mailbox(pk, offs.long(), 512)
    with pytest.raises(ValueError):
        C.mailbox(pk, offs, 514)
    with pytest.raises(ValueError):
        C.mailbox(pk, offs, 512, out=torch.zeros((2, 256)))
    with pytest.raises(TypeError):
        C.mailbox(pk, offs, 512, out=torch.zeros((2, 512)).double())


@pytest.mark.parametrize("script", [proto_torch, grid_torch])
def test_script_main_on_the_cpu(script):
    res = script.main(["--cpu"])
    checks = [v for v in res.values() if isinstance(v, dict)]
    assert len(checks) == {proto_torch: 3, grid_torch: 2}[script]
    assert all(c["bit_exact"] for c in checks)
    assert res["device"] == "cpu"


@pytest.mark.parametrize("script", [proto_torch, grid_torch])
def test_script_raises_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script runs the kernels")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main([])
