"""The port stands alone: no module of vpic_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package (an AST scan, so nothing is
executed)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "vpic_tpu_torch").rglob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "vpic_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_package_files_found():
    assert "vpic_tpu_torch/__init__.py" in FILES
    assert "vpic_tpu_torch/ops/fused_push.py" in FILES
    assert "vpic_tpu_torch/scripts/field_fuse_proto.py" in FILES
    for mod in ("__main__", "checkpoint", "diagnostics", "dump", "native/io",
                "ops/hydro", "models/shapes", "collision", "emitter",
                "models/reconnection", "models/emission"):
        assert f"vpic_tpu_torch/{mod}.py" in FILES, mod


@pytest.mark.parametrize("rel", FILES + ["chip_smoke.py"])
def test_no_jax_import(rel):
    roots = set(_imported_roots(ROOT / rel))
    assert not roots & set(FORBIDDEN), f"{rel} imports {roots & set(FORBIDDEN)}"


def test_kernel_hash_covers_included_headers(tmp_path, monkeypatch):
    """A library is named by the hash of its .cu and of every csrc header
    it includes (recursively), so an edited shared header rebuilds."""
    from vpic_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "a.cuh"\nint k;\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\nint b;\n')
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.sources("k")] == ["k.cu", "a.cuh",
                                                     "b.cuh"]
    before = _build._paths("k")[1]
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\nint c;\n')
    after = _build._paths("k")[1]
    assert before != after and after.name.startswith("k-")
    # the real kernels: every header they include is in their hash
    monkeypatch.undo()
    assert {p.name for p in _build.sources("fused_push3d")} == {
        "fused_push3d.cu", "push_lane.cuh", "block_scan.cuh"}
    assert {p.name for p in _build.sources("fused_push2d")} == {
        "fused_push2d.cu", "push_lane.cuh"}
    assert {p.name for p in _build.sources("compact_block")} == {
        "compact_block.cu"}
    assert {p.name for p in _build.sources("mailbox")} == {"mailbox.cu"}
    assert {p.name for p in _build.sources("field_beb")} == {"field_beb.cu"}


def test_nvcc_line_has_the_include_dir(monkeypatch, tmp_path):
    """build_many passes -I csrc, and starts one nvcc per source before
    waiting on any (recorded with a stand-in for nvcc)."""
    from vpic_tpu_torch.ops import _build
    calls = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            calls.append(("start", cmd))
            self.cmd = cmd

        def communicate(self):
            calls.append(("wait", self.cmd))
            out = Path(self.cmd[self.cmd.index("-o") + 1])
            out.write_bytes(b"")
            return "ptxas info    : Used 1 registers", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    libs = _build.build_many(["fused_push2d", "merge_p"])
    assert [c[0] for c in calls] == ["start", "start", "wait", "wait"]
    for _, cmd in calls:
        assert cmd[cmd.index("-I") + 1] == str(_build.CSRC)
        assert "arch=compute_90a,code=sm_90a" in cmd
    assert all(p.exists() for p in libs)
    assert "ptxas info" in _build.build_log("merge_p")
