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


@pytest.mark.parametrize("rel", FILES + ["chip_smoke.py"])
def test_no_jax_import(rel):
    roots = set(_imported_roots(ROOT / rel))
    assert not roots & set(FORBIDDEN), f"{rel} imports {roots & set(FORBIDDEN)}"
