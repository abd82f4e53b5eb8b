"""What every cell of the benchmark shares: where its files are, its
declarations in `BENCHMARK.json`, the seeds, the card's state from
`nvidia-smi`, the look for forbidden modules, and the result line.

This module imports neither torch nor the program: `run.py` sets the cache
directories before either is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: the root of the checkout: the benchmark runs from it
ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
#: build and kernel caches of the program, at fixed paths inside the checkout
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": ROOT / "build" / "benchmark" / "torch_extensions",
    "TRITON_CACHE_DIR": ROOT / "build" / "benchmark" / "triton",
    "CUDA_CACHE_PATH": ROOT / "build" / "benchmark" / "cuda_cache",
}
#: top-level modules no run may hold once its window has closed: the JAX
#: package, JAX itself and the libraries that come with it
FORBIDDEN = ("jax", "jaxlib", "flax", "zeggs_tpu")


def set_cache_dirs():
    """Point every build and kernel cache at its fixed directory in the
    checkout (the program's own nvcc libraries already live under
    ``build/zeggs_tpu_torch``)."""
    for key, path in CACHE_DIRS.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    os.environ.setdefault("USE_FLAX", "0")


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def read_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of `BENCHMARK.json`, with its configuration, its traffic
    mix and the metrics it reports."""

    def __init__(self, name, bench=None):
        bench = bench if bench is not None else read_json(ROOT / "BENCHMARK.json")
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"unknown workload {name!r}: {sorted(by_name)}")
        self.name = name
        self.workload = by_name[name]
        self.chips = int(self.workload["chips"])
        conf = {c["name"]: c for c in bench["configs"]}[self.workload["config"]]
        self.config = read_json(ROOT / conf["file"])
        self.mix = read_json(HERE / "traffic" / "mixes" / f"{self.workload['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def _reports(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]


def seed_of(seed, *words):
    """A 63-bit seed for one use (``words``) of the run's ``--seed``."""
    return int(np.random.SeedSequence([int(seed) % 2**64, *map(int, words)])
               .generate_state(2, np.uint64)[0] >> np.uint64(1))


def smi():
    """The card's name, clocks, power draw, power limit and temperature as
    `nvidia-smi` reads them (one line a card), or why it could not."""
    fields = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu,pstate"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip() or out.stderr.strip()


def forbidden_modules(modules=None):
    """The top-level names of loaded modules that a run may not hold,
    compared whole (``zeggs_tpu_torch`` is not ``zeggs_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


class Clock:
    """Seconds since the process started (the interpreter's own start is
    read from /proc where it exists)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        try:
            with open("/proc/self/stat") as f:
                start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
            with open("/proc/uptime") as f:
                uptime = float(f.read().split()[0])
            self.t0 -= max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
        except (OSError, ValueError, IndexError):
            pass

    def __call__(self):
        return time.perf_counter() - self.t0


def result_line(correct, attempted, failed, metrics, device, checks, breakdown=None):
    """The run's last line: the contract's keys, then the numbers compared
    and their limits under ``checks``, last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
