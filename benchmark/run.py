"""Run one cell of the benchmark of `zeggs_tpu_torch` on the card(s) of this
machine and print its result as the last line of standard output.

    python -m benchmark.run --workload v1.train --seed 7 --seconds 30 --trace 0

Everything is found by name: the cell in `BENCHMARK.json` names its
configuration (`benchmark/configs/<name>.json`) and its traffic mix
(`benchmark/traffic/mixes/<mix>.json`), the mix names its generator
(`benchmark/traffic/<generator>.py`), and each per-layer metric has a reader
(`benchmark/metrics/<metric>.py`, else the one of the part of its name
before the first dot: `device_idle.py` reads every `device_idle.<cell>`).

A run: set-up (imports, kernels, weights and inputs from the seed, warm-up
of every shape the traffic uses, captures), the measured window, with
``--trace 1`` a traced stretch after it, then the peak memory, and once the
program's state is freed the comparison with the plain reference that
decides ``correct``. Without a card, or with fewer cards than the cell
asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys

from .common import Clock, HERE, Cell, forbidden_modules, log, result_line, set_cache_dirs, smi


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator_of(cell):
    return load_module(HERE / "traffic" / f"{cell.mix['generator']}.py",
                       f"benchmark.traffic.{cell.mix['generator']}")


def read_metric(name, run, trace):
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        name = name.split(".")[0]
        path = HERE / "metrics" / f"{name}.py"
    return load_module(path, f"benchmark.metrics.{name}").read(run, trace)


def execute(cell, seed, seconds, trace, device, clock, config=None):
    """Set up, measure, trace and check one run of ``cell`` on ``device``
    -> the result (a dict) and the checks' stderr lines. ``config``
    replaces the cell's configuration (the tests' narrow rehearsal)."""
    import torch

    from . import trace as T

    log(f"card before set-up: {smi()}")
    cfg = config if config is not None else cell.config
    run = generator_of(cell).Run(cell, cfg, seed, device)
    run.setup()
    setup_s = clock()
    log(f"set-up {setup_s:.3f} s ({run.setup_parts()}); card: {smi()}")
    e2e = run.window(seconds)
    log(f"window: {e2e}; card after the window: {smi()}")
    tr = None
    if trace:
        with T.traced(device) as tr:
            run.traced_stretch()
        log(f"traced {tr.window_s:.3f} s ({tr.profiler_s():.3f} s of it the profiler's own "
            f"idle time), {len(tr.device)} device and {len(tr.host)} host events; "
            f"card: {smi()}")
        log(f"host events by total time: {tr.top_host()}")
    on_card = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    per_layer = {}
    if trace:
        for m in cell.per_layer:
            value = read_metric(m["name"], run, tr)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
    run.release()
    try:
        checks = run.check()
    finally:
        run.close()
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace:
        metrics = per_layer
    else:
        values = dict(e2e["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        dev.update(busy_s=tr.busy_s() if on_card else 0.0, window_s=tr.window_s)
    result = {"correct": correct, "attempted": e2e["attempted"], "failed": e2e["failed"],
              "metrics": metrics, "device": dev, "checks": checks,
              "breakdown": tr.breakdown() if trace else None}
    return result


def main(argv=None):
    clock = Clock()
    set_cache_dirs()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, args.trace, "cuda", clock)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(result_line(result["correct"], result["attempted"], result["failed"],
                      result["metrics"], result["device"], result["checks"],
                      result["breakdown"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
