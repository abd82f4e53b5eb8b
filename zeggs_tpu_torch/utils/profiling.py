"""Profiling and timing helpers (counterpart of `zeggs_tpu/utils/profiling.py`):
the program's spans and counters, a `torch.profiler` trace written as a
Chrome trace, a timing loop that waits for the card, and per-card memory
statistics.

Spans. `annotate` is the one span helper of the port. A program span is
named ``zeggs:<layer>.<stage>``, with ``#<request id>`` where it belongs to
one request. It is a `torch.profiler.record_function` range when tracing is
on: inside `trace` (on every thread), or on a thread that a profiler
traces (`torch.autograd._profiler_enabled`; a profiler that traces only
its own thread does not see worker threads). Otherwise it is one shared
null context: no range is made, and the gate costs a fraction of a
microsecond. Spans are stamped by the same profiler as CUPTI's device
events, so they lie on the device trace's clock by construction. A span
never sits inside a body a CUDA graph captures (it would run at capture
time only): spans wrap the calls that replay graphs.

Counters. `count` adds to a process-wide counter, always on, under one
lock; `counters` is a snapshot. Each reading is a total since the process
started, so a reader of a stretch takes two and subtracts. Each kernel
wrapper of `ops/kernels/` counts its launches as ``<kernel>.launches``
(names from `ops.kernels.build.KERNELS`).

Work captured into a CUDA graph runs at each replay, not when it is
captured. So while the current CUDA stream captures, `count` adds to that
stream's tally and not to the totals. The tally is kept by stream, not by
thread: a backward that the autograd engine runs on its own thread during
a capture runs on the forward's stream, and lands in the same graph. A
graph's owner takes two readings of the tally around its capture
(`captured`); each replay adds their difference back (`replayed`).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from pathlib import Path

import numpy as np
import torch

_lock = threading.Lock()
_counters = {}
#: capture stream's handle -> what `count` added while the stream captured
_captured = {}
#: open `trace` contexts: while any is open, every thread's spans are made
_tracing = 0
_OFF = contextlib.nullcontext()


def annotate(name, rid=None):
    """A named span, ``name#rid`` with a request id: a
    `torch.profiler.record_function` when tracing is on (see the module's
    docstring), else a shared null context."""
    if not (_tracing or torch.autograd._profiler_enabled()):
        return _OFF
    return torch.profiler.record_function(name if rid is None else f"{name}#{rid}")


def _capturing_stream():
    """The current CUDA stream's handle while it captures a graph, else None."""
    if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
        return torch.cuda.current_stream().cuda_stream
    return None


def count(name, n=1):
    """Add ``n`` to the counter ``name``, or, while the current CUDA stream
    captures a graph, to that stream's tally."""
    stream = _capturing_stream()
    with _lock:
        store = _counters if stream is None else _captured.setdefault(stream, {})
        store[name] = store.get(name, 0) + n


def counters():
    """A copy of every counter: {name: total since the process started}."""
    with _lock:
        return dict(_counters)


def captured(stream):
    """A reading of ``stream``'s capture tally: a `collections.Counter` of
    what `count` has added while the stream captured. The difference of two
    readings around a capture is what each replay of its graph counts."""
    with _lock:
        return collections.Counter(_captured.get(stream.cuda_stream, {}))


def replayed(counts):
    """Count one replay of a graph that captured ``counts`` (the difference
    of two `captured` readings): add each to its counter."""
    with _lock:
        for name, n in counts.items():
            _counters[name] = _counters.get(name, 0) + n


def _all_threads():
    """The profiler option that records every thread's ranges, where the
    installed torch has it (else None)."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block (host, and the cards when there are any;
    every thread's spans, where the installed torch records all threads)
    and write ``<logdir>/trace.json``, viewable in Perfetto or
    chrome://tracing; yields the profiler, whose ``key_averages()`` sums
    the time by operator and kernel:

        with profiling.trace("traces") as prof:
            trainer.train_step(batch)
    """
    global _tracing
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    config = _all_threads()
    options = {} if config is None else {"experimental_config": config}
    with torch.profiler.profile(activities=activities, **options) as prof:
        with _lock:
            _tracing += 1
        try:
            yield prof
        finally:
            with _lock:
                _tracing -= 1
    prof.export_chrome_trace(str(logdir / "trace.json"))


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
