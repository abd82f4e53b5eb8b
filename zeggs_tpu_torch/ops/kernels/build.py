"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel is one `csrc/<name>.cu` with a plain C interface, compiled for
Hopper at first use into ``build/zeggs_tpu_torch/`` at the root of the
checkout. The library's file name carries a hash of its source and flags,
so a stale build is never loaded. PyTorch's headers are not included: a
file with a plain C interface builds in seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "zeggs_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: every csrc/<name>.cu of the port
KERNELS = ("decoder_rollout", "gru_cell", "mel_spectrogram")
_load_lock = threading.Lock()


def nvcc():
    """Path of nvcc: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise FileNotFoundError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(name):
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name):
    """Compile csrc/<name>.cu unless this source is already built; returns
    the library's path. nvcc's report (registers, spills) is kept beside it
    as <library>.log."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, path)
    return path


def build_all():
    """Build every kernel, one nvcc each, all at once; returns the paths."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return list(pool.map(build, KERNELS))


@functools.cache
def _load(name):
    return ctypes.CDLL(str(build(name)))


def load(name):
    """Build (if needed) and load csrc/<name>.cu as a ctypes library. Safe
    to call from several threads: the first call builds, the others wait."""
    with _load_lock:
        return _load(name)
