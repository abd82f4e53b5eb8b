"""The device trace of a stretch of a run (`torch.profiler`, CUPTI) and what
the per-layer readers take from it: the union of the device's busy
intervals, the kernels by name, and the idle gaps labelled by what the host
was doing.

CUPTI reports the time it takes for itself (its buffer flushes and
instrumentation) as overhead events. The device idles under them only
because it is traced: the idle share and the idle gaps leave that time out.

Events are read from the profiler's raw kineto records: a Python object an
event (`key_averages`) costs tens of seconds for a train step's ~120k
kernels.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

#: names of the benchmark's own spans around calls into the program
SPAN_PREFIX = "bench:"
#: the names kineto gives CUPTI's overhead records
OVERHEAD = frozenset({"Buffer Flush", "Instrumentation", "Resource", "Driver Compiler",
                      "Activity Buffer Request", "Command Buffer Full"})


def union(iv):
    """The union of (n, 2) intervals, sorted, as an (m, 2) array."""
    if len(iv) == 0:
        return np.zeros((0, 2), np.int64)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.r_[True, iv[1:, 0] > ends[:-1]])
    last = np.r_[first[1:] - 1, len(iv) - 1]
    return np.stack([iv[first, 0], ends[last]], 1)


def subtract(iv, cut):
    """The parts of the sorted disjoint intervals ``iv`` outside the sorted
    disjoint intervals ``cut``."""
    out, j = [], 0
    for s, e in iv:
        while j < len(cut) and cut[j][1] <= s:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < e:
            if cut[k][0] > s:
                out.append((s, cut[k][0]))
            s = max(s, cut[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return np.array(out, np.int64).reshape(-1, 2)


def length_s(iv):
    return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9 if len(iv) else 0.0


@dataclass
class Trace:
    """One traced stretch: its wall seconds, and the device's and the
    host's events as (name, start ns, end ns)."""

    window_s: float
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    def busy_intervals(self):
        """The union of the device events' intervals, sorted, as an (n, 2)
        array of ns."""
        return union(np.array([(s, e) for _, s, e in self.device], np.int64).reshape(-1, 2))

    def busy_s(self):
        return length_s(self.busy_intervals())

    def profiler_intervals(self):
        """The time under CUPTI's overhead records in which the device ran
        nothing."""
        cut = union(np.array([(s, e) for n, s, e in self.host if n in OVERHEAD],
                             np.int64).reshape(-1, 2))
        return subtract(cut, self.busy_intervals())

    def profiler_s(self):
        return length_s(self.profiler_intervals())

    def idle_share(self):
        """1 - busy / (wall - the profiler's own idle time), in %; None when
        the device ran nothing."""
        busy = self.busy_s()
        return None if busy <= 0 else 100.0 * (1.0 - busy / (self.window_s - self.profiler_s()))

    def kernels(self, name_part):
        """(count, device seconds) of the device events whose name holds
        ``name_part``."""
        d = [e - s for n, s, e in self.device if name_part in n]
        return len(d), float(sum(d)) / 1e9

    def top_ops(self, n=10):
        by = defaultdict(int)
        for name, s, e in self.device:
            by[name] += e - s
        return [[k[:120], v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_host(self, n=8):
        """[name, calls, seconds] of the host events that took most time."""
        by = defaultdict(lambda: [0, 0])
        for name, s, e in self.host:
            by[name][0] += 1
            by[name][1] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1][1])[:n]
        return [[k[:80], c, t / 1e9] for k, (c, t) in top]

    def idle_gaps(self, n=10):
        """The ``n`` longest gaps between busy intervals inside the traced
        stretch, less the profiler's own time, each named by the shortest
        host event (a benchmark span, an operator or a runtime call) that
        covers the whole gap, else the one that covers its middle."""
        iv = self.busy_intervals()
        if len(iv) < 2:
            return []
        gaps = subtract(np.stack([iv[:-1, 1], iv[1:, 0]], 1), self.profiler_intervals())
        order = np.argsort(gaps[:, 0] - gaps[:, 1])[:n]
        host = sorted((h for h in self.host if h[0] not in OVERHEAD), key=lambda h: h[2] - h[1])
        out = []
        for g0, g1 in gaps[order]:
            mid = (g0 + g1) // 2
            label = next((h[0] for h in host if h[1] <= g0 and h[2] >= g1), None)
            if label is None:
                label = next((h[0] for h in host if h[1] <= mid <= h[2]), "host: untraced")
            out.append([label[:120], float(g1 - g0) / 1e9])
        return out

    def breakdown(self):
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


@contextlib.contextmanager
def traced(device):
    """Trace the body on ``device``; yields a `Trace` that is filled when
    the body ends (after a synchronize)."""
    from torch.autograd import DeviceType

    on_card = torch.device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    trace = Trace(0.0)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield trace
        if on_card:
            torch.cuda.synchronize(device)
        trace.window_s = time.perf_counter() - t0
    for e in prof.profiler.kineto_results.events():
        start, name = e.start_ns(), e.name()
        rec = (name, start, start + e.duration_ns())
        if e.device_type() != DeviceType.CUDA:
            trace.host.append(rec)
        elif not (e.is_user_annotation() or name.startswith(SPAN_PREFIX)):
            # a span's copy on the device's timeline is no device work
            trace.device.append(rec)


def span(name):
    """A benchmark span around a call into the program (shows in the
    trace's host events, and names the idle gaps it covers)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)
