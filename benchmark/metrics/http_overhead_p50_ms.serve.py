"""``http_overhead_p50_ms.serve``: the median over the window's 200 replies
of the client's latency (from when the request was due) less the daemon's
own ``latency_ms`` (from enqueue to done): the HTTP front end, the JSON and
the reply's transfer, and any lateness of the sender."""

import statistics


def read(run, trace):
    gaps = [(r["done"] - r["due"]) * 1e3 - r["latency_ms"] for r in run.replies()
            if "latency_ms" in r]
    return statistics.median(gaps) if gaps else None
