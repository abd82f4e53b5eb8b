"""Profiling and timing helpers (counterpart of `zeggs_tpu/utils/profiling.py`):
a `torch.profiler` trace written as a Chrome trace, named regions, a
timing loop that waits for the card, and per-card memory statistics."""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block (host, and the cards when there are any)
    and write ``<logdir>/trace.json``, viewable in Perfetto or
    chrome://tracing; yields the profiler, whose ``key_averages()`` sums
    the time by operator and kernel:

        with profiling.trace("traces") as prof:
            trainer.train_step(batch)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(logdir / "trace.json"))


def annotate(name):
    """A named region inside a trace."""
    return torch.profiler.record_function(name)


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters=10, warmup=2, **kwargs):
    """Wall times of ``fn(*args, **kwargs)``, each closed by a
    `torch.cuda.synchronize` when a card is in use -> dict(median_s, p10_s,
    p90_s, times)."""
    for _ in range(warmup):
        fn(*args, **kwargs)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {
        "median_s": float(np.median(arr)),
        "p10_s": float(np.percentile(arr, 10)),
        "p90_s": float(np.percentile(arr, 90)),
        "times": times,
    }


def device_memory_stats():
    """{"cuda:<i>": `torch.cuda.memory_stats(i)`} for every visible card;
    without a card {"cpu": None}, since the CPU allocator keeps no
    statistics."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
