"""Build and load the port's CUDA kernels.

Each kernel lives in ``vpic_tpu_torch/csrc/<name>.cu`` with a plain
``extern "C"`` interface; shared device code lives in ``csrc/*.cuh``
headers, found through ``-I csrc``.  At first use a kernel is compiled with
nvcc into a shared library under ``build/kernels/`` at the root of the
checkout, named by a hash of its source, of every header it includes
(followed recursively) and of the flags, so an edited source or header
rebuilds, and loaded with ctypes.  Nothing here runs at import: a machine without nvcc can import
the package and use the plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str):
    """csrc/<name>.cu followed by every csrc header it includes, directly or
    through another header, each once, in the order first reached."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(CSRC / inc.decode())
    return seen


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    digest = _digest(name)
    base = BUILD_DIR / f"{name}-{digest}"
    return src, base.with_suffix(".so"), base.with_suffix(".log")


def build_many(names) -> list:
    """Compile every csrc/<name>.cu in ``names`` that has no up-to-date
    library yet, one nvcc process per source, all started together; returns
    the libraries' paths in order.  The compiler's output (``-Xptxas -v``:
    registers, spills, shared memory per kernel) is kept beside each, see
    build_log."""
    jobs = []
    for name in names:
        src, lib, log = _paths(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, lib, log, tmp, cmd, proc))
    failed = []
    for src, lib, log, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}:\n{out}")
            continue
        log.write_text(" ".join(cmd) + "\n" + out)
        os.replace(tmp, lib)    # atomic: concurrent builders never see a partial
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_paths(name)[1] for name in names]


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists; returns
    the library's path (see build_many)."""
    return build_many([name])[0]


def build_log(name: str) -> str:
    """The nvcc command and output recorded when csrc/<name>.cu was built."""
    return _paths(name)[2].read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name)))
    return _libs[name]
