"""Nothing the harness or the reference loads is JAX or the JAX package,
compared by whole top-level names."""

import subprocess
import sys

from benchmark import core

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from benchmark import core, readings
from benchmark.tests import bench_helpers
sp = bench_helpers.tiny("harris2d.64sq.64ppc")
sp.config["params"]["taui"] = 4.0
out = core.run_cell(sp, bench_helpers.SEED, 0.0, False, "cpu")
assert out["correct"], out
for m in (p.stem for p in (core.HERE / "metrics").glob("*.py")):
    core.reader(m)
print("LOADED", " ".join(sorted({{n.split(".", 1)[0] for n in sys.modules}})))
"""


def test_forbidden_names_are_whole_names():
    saved = dict(sys.modules)
    try:
        sys.modules["vpic_tpu_torch_probe"] = sys
        sys.modules["jaxtyping_probe"] = sys
        assert core.forbidden_loaded() == [] or all(
            n.split(".")[0] in core.FORBIDDEN for n in core.forbidden_loaded())
        assert "vpic_tpu_torch_probe" not in core.forbidden_loaded()
        sys.modules["vpic_tpu.probe"] = sys
        assert "vpic_tpu.probe" in core.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=str(core.ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(core.ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("LOADED")][-1]
    tops = set(line.split()[1:])
    assert "vpic_tpu_torch" in tops and "benchmark" in tops
    assert not tops & set(core.FORBIDDEN), tops & set(core.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (core.HERE / "reference").glob("*.py"):
        text = path.read_text()
        for name in ("vpic_tpu", "jax"):
            assert f"import {name}" not in text and \
                f"from {name}" not in text, path.name
