"""ctypes bindings for the native buffered dump writer
(``vpic_tpu_torch/csrc/io_writer.cpp``, counterpart of
``vpic_tpu/native/io.py``).  This is file I/O on the host, not a device
kernel.  The library is compiled with g++ at first use into
``build/native/`` at the root of the checkout, named by a hash of the
source and the flags as ``ops/_build`` names the kernels, and loaded with
ctypes; where no compiler is found the writes fall back to Python file
I/O, as the JAX module does."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "csrc" / "io_writer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"io_writer-{h.hexdigest()[:16]}.so"


def _build(so: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, so)       # atomic: concurrent builders never see a partial


def _load():
    """The loaded library, or False where it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.vpic_write_file.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                            ctypes.c_size_t]
            lib.vpic_write_file.restype = ctypes.c_int
            lib.vpic_writer_open.argtypes = [ctypes.c_char_p]
            lib.vpic_writer_open.restype = ctypes.c_void_p
            lib.vpic_writer_write.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p,
                                              ctypes.c_size_t]
            lib.vpic_writer_write.restype = ctypes.c_int
            lib.vpic_writer_close.argtypes = [ctypes.c_void_p]
            lib.vpic_writer_close.restype = ctypes.c_longlong
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib = False  # no toolchain: Python fallback
        return _lib


def write_file(path: str, data: bytes) -> None:
    lib = _load()
    if lib:
        buf = ctypes.create_string_buffer(data, len(data))
        if lib.vpic_write_file(str(path).encode(), buf, len(data)) != 0:
            raise IOError(f"native write failed: {path}")
        return
    with open(path, "wb") as fh:
        fh.write(data)


class AsyncWriter:
    """Double-buffered async file writer (P2PIOPolicy analogue)."""

    def __init__(self, path: str):
        self._lib = _load()
        self._path = path
        if self._lib:
            self._h = self._lib.vpic_writer_open(str(path).encode())
            if not self._h:
                raise IOError(f"cannot open {path}")
            self._fh = None
        else:
            self._h = None
            self._fh = open(path, "wb")

    def write(self, data: bytes):
        if self._h:
            buf = ctypes.create_string_buffer(data, len(data))
            if self._lib.vpic_writer_write(self._h, buf, len(data)):
                raise IOError("native enqueue failed")
        else:
            self._fh.write(data)

    def close(self) -> int:
        if self._h:
            n = self._lib.vpic_writer_close(self._h)
            self._h = None
            if n < 0:
                raise IOError(f"async write failed: {self._path}")
            return int(n)
        self._fh.close()
        return 0
