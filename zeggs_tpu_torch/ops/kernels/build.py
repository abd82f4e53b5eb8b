"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel is one `csrc/<name>.cu` with a plain C interface, compiled for
Hopper at first use into ``build/zeggs_tpu_torch/`` at the root of the
checkout; the `*.cuh` headers in csrc/ are shared. The library's file name
carries a hash of its source, the headers and the flags, so a stale build
is never loaded. PyTorch's headers are not included: a
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

from ...utils import profiling

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "zeggs_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: every csrc/<name>.cu of the port; its wrapper counts its launches as
#: the `utils.profiling` counter ``<name>.launches``
KERNELS = ("decoder_rollout", "decoder_step", "decoder_train", "gru_cell", "mel_spectrogram")
_load_lock = threading.Lock()


def nvcc():
    """Path of nvcc: on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise FileNotFoundError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(name):
    """The library's path, named by a hash of its source, the headers in
    csrc/ and the flags."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    data = b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(data).hexdigest()[:16]
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


def launches():
    """Each kernel's launches in this process so far, read from the
    `utils.profiling` counters: {kernel: count}."""
    totals = profiling.counters()
    return {name: totals.get(f"{name}.launches", 0) for name in KERNELS}


def launches_since(before):
    """Each kernel's launches since the reading ``before`` (`launches`)."""
    return {name: n - before[name] for name, n in launches().items()}
