"""ctypes bindings for the host-IO float parser and formatter
(`csrc/fastparse.cpp`, the port's copy of the JAX package's native parser).

The library is built on first use with the host C++ compiler into
``build/zeggs_tpu_torch/`` at the root of the checkout, under a name that
carries a hash of its source, so a stale build is never loaded. Without a
compiler the callers keep their NumPy path: BVH parsing and export are host
work, and this only makes them faster.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "fastparse.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zeggs_tpu_torch"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    """Compile the parser unless this source is already built; returns the
    library's path, or None without a compiler or on a failed build."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    path = _BUILD_DIR / f"libfastparse_{digest}.so"
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(_SRC)], capture_output=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)
    return path


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.parse_floats.restype = ctypes.c_long
        lib.parse_floats.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ]
        lib.count_first_row.restype = ctypes.c_long
        lib.count_first_row.argtypes = [ctypes.c_char_p, ctypes.c_long]
        lib.format_float_matrix.restype = ctypes.c_long
        lib.format_float_matrix.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.c_char_p, ctypes.c_long,
        ]
        _lib = lib
        return _lib


def available():
    return _load() is not None


def parse_float_matrix(text: str):
    """Parse a whitespace-delimited numeric block -> (rows, cols) float64
    (values parsed as float32). Returns None when the library is unavailable
    or the block is ragged (callers fall back to np.loadtxt)."""
    lib = _load()
    if lib is None:
        return None
    data = text.encode()
    n_bytes = len(data)
    cols = lib.count_first_row(data, n_bytes)
    if cols <= 0:
        return None
    max_count = n_bytes // 2 + cols  # at least 2 bytes per number
    out = np.empty(max_count, np.float32)
    n = lib.parse_floats(data, n_bytes, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         max_count)
    if n % cols != 0:
        return None
    return out[:n].reshape(n // cols, cols).astype(np.float64)


def format_float_matrix(values):
    """Format (rows, cols) floats as '%f' rows (the BVH motion block).
    Returns None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(values, np.float32)
    rows, cols = vals.shape
    cap = rows * cols * 32
    buf = ctypes.create_string_buffer(cap)
    n = lib.format_float_matrix(vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols,
                                buf, cap)
    if n < 0:
        return None
    return buf.raw[:n].decode()
