"""Build and load the port's CUDA kernels.

Each kernel lives in ``vpic_tpu_torch/csrc/<name>.cu`` with a plain
``extern "C"`` interface.  At first use it is compiled with nvcc into a
shared library under ``build/kernels/`` at the root of the checkout (named
by a hash of its source and flags, so an edited source rebuilds) and loaded
with ctypes.  Nothing here runs at import: a machine without nvcc can import
the package and use the plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict = {}


def nvcc() -> str:
    """The nvcc to build with: $CUDA_HOME/bin/nvcc, else the one on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    base = BUILD_DIR / f"{name}-{digest}"
    return src, base.with_suffix(".so"), base.with_suffix(".log")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists; returns
    the library's path.  The compiler's output (``-Xptxas -v``: registers,
    spills, shared memory per kernel) is kept beside it, see build_log."""
    src, lib, log = _paths(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    os.replace(tmp, lib)    # atomic: concurrent builders never see a partial
    return lib


def build_log(name: str) -> str:
    """The nvcc command and output recorded when csrc/<name>.cu was built."""
    return _paths(name)[2].read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)))
    return _libs[name]
