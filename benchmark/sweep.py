"""The sweep that fixes a daemon cell's load, run once by hand, whose
result is written into the cell's mix as a number:

    python -m benchmark.sweep --workload v1.serve --values 8,12,16,20 --seconds 20
    python -m benchmark.sweep --workload v2.stream --values 4,8,12,16 --seconds 20

One set-up, then a window at each value: the arrival rate (req/s) of
``v1.serve``, the number of live sessions of ``v2.stream`` (set-up starts
the largest). A JSON line a value: the latencies' median, 95th percentile
and maximum, the share of calls within ``--limit-ms``, the failures, and
the median latency of the window's last quarter over its first (a backlog
that grows reads well above 1).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .common import Cell, set_cache_dirs
from .run import generator_of


def summary(recs, limit_ms):
    recs = sorted(recs, key=lambda r: r["due"])
    lat = np.array([(r["done"] - r["due"]) * 1e3 if r["status"] == 200 else np.inf
                    for r in recs])
    q = max(1, len(lat) // 4)
    return {"n": len(lat), "failed": int(np.sum(~np.isfinite(lat))),
            "p50_ms": float(np.median(lat)), "p95_ms": float(np.quantile(lat, 0.95)),
            "max_ms": float(np.max(lat)), "within_limit": float(np.mean(lat <= limit_ms)),
            "last_over_first": float(np.median(lat[-q:]) / np.median(lat[:q])),
            "batch_rows": float(np.mean([r.get("batch_size", 0) for r in recs]))}


def main(argv=None):
    set_cache_dirs()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--values", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--limit-ms", type=float, default=500.0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    values = [float(v) for v in args.values.split(",")]
    streams = cell.mix["generator"] == "stream_sessions"
    if streams:
        cell.mix = dict(cell.mix, sessions=int(max(values)))
    run = generator_of(cell).Run(cell, cell.config, args.seed, "cuda")
    run.setup()
    try:
        for v in values:
            if streams:
                run.active = int(v)
            else:
                run.mix["rate"] = v
            run.window(args.seconds)
            print(json.dumps({"workload": cell.name, "value": v,
                              **summary(run.recs, args.limit_ms)}), flush=True)
    finally:
        run.release()
        run.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
