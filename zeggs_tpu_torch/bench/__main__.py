"""The bench's orchestrator (counterpart of `bench.py`'s ``main``).

    python -m zeggs_tpu_torch.bench [--quick] [--full-run-curve PATH]
    python -m zeggs_tpu_torch.bench --device cpu --tiny [--quick]   # a rehearsal

Metric: gesture frames/s on one card for batched synthesis with the v1
model (75 joints, decoder GRU 2 x 1024, speech/style 64), beside the B=1
latency of a 10 s clip. The target is 20x realtime a card, 1200 frames/s;
``vs_baseline`` is value / 1200.

Each stage runs in its own process (``python -m zeggs_tpu_torch.bench.<stage>``),
so that CUDA graph pools, the caching allocator and the kernels' launch
counters of one stage never meet another's: core, then serve, streaming,
train (float32) and train_bf16. The kernels are built once here, before the
first stage. The headline line (``metric``, ``value``, ``unit``,
``vs_baseline``, ``extra``) is printed right after the core stage and again
after every later stage, so the last line printed is always whole.

Budget: ``ZEGGS_BENCH_BUDGET_S`` seconds (default 1140) for the whole run.
A stage starts only while the budget covers its estimate (else it is marked
``skipped_over_budget``); its process's time limit keeps the later stages'
estimates, and the stages that take ``--budget`` get what is left of it.

Unlike `bench.py`: with no card the orchestrator prints one error and exits
1; it never falls back to the CPU, which runs only under ``--device cpu``
(``extra.platform`` "cpu", ``extra.rehearsal`` true). A stage that fails is
recorded as ``{"failed": ...}``; the other stages still run and the last
line is printed, and then the orchestrator exits 1 (a stage skipped over
budget leaves the exit code 0). ``extra.full_run`` summarises a curve the
port wrote (``--full-run-curve``, the JSON of `cli/train_full.py`), never
the JAX run's `docs/full_run_curve.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import fixture as FX

BASELINE = 20 * 60.0  # 20x realtime a card
#: each stage's estimated seconds on the card, full run and --quick: about
#: twice (full) and 1.3 to 3 times (quick) the walls read on an NVIDIA H100
#: 80GB HBM3 at 700 W (PERF.md section 5)
ESTIMATES = {"core": (90, 60), "serve": (60, 40), "streaming": (40, 30),
             "train": (90, 60), "train_bf16": (90, 60)}
#: the stages after core: (key, module, its arguments, ... with --quick,
#: whether it takes --budget, the environment variable that turns it off)
STAGES = (
    ("serve", "serve", ["--requests", "20", "--daemon"], ["--requests", "4", "--daemon"], True,
     "ZEGGS_BENCH_SERVE"),
    ("streaming", "streaming", ["--seconds", "30", "--http"], ["--seconds", "5", "--http"], True,
     "ZEGGS_BENCH_STREAMING"),
    ("train", "train", [], ["--iters", "3", "--turns", "3"], False, "ZEGGS_BENCH_TRAIN"),
    ("train_bf16", "train", ["--bf16"], ["--bf16", "--iters", "3", "--turns", "3"], False,
     "ZEGGS_BENCH_TRAIN"),
)


class StageFailed(RuntimeError):
    """A stage exited non-zero or printed no JSON line; ``partial`` holds
    the line it did print."""

    def __init__(self, msg, partial=None):
        super().__init__(msg)
        self.partial = partial or {}


def _stage(module, *args):
    return ["-m", f"zeggs_tpu_torch.bench.{module}", *args]


def _run_stage(argv, timeout):
    """Run one stage in its own process from the repository's root -> its
    last JSON line. Its stderr (progress lines) goes to ours."""
    proc = subprocess.run([sys.executable] + argv, capture_output=True, text=True,
                          timeout=timeout, cwd=FX.REPO)
    if proc.stderr.strip():
        print(proc.stderr.rstrip(), file=sys.stderr, flush=True)
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.startswith("{")]
    try:
        out = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        out = None
    if proc.returncode != 0 or out is None:
        raise StageFailed(f"stage {argv[1]} rc={proc.returncode}: {proc.stderr[-2000:]}", out)
    return out


def _emit(core, extras):
    """Print the whole artifact line: after the core stage and again after
    every later stage, so the line last printed when this process is killed
    is whole."""
    value = core.get("best_fps")
    print(json.dumps({
        "metric": "gesture_frames_per_sec_per_chip",
        "value": value,
        "unit": "frames/s",
        "vs_baseline": round(value / BASELINE, 3) if value is not None else None,
        "extra": {
            "platform": extras["device"]["platform"],
            "b1_latency_10s_clip_ms": core.get("lat_ms"),
            **({"b1_latency_int8_ms": core["lat8_ms"]} if core.get("lat8_ms") else {}),
            **({"batched_int8_fps": core["fps8"]} if core.get("fps8") else {}),
            **({"b1_dispatch_p50_ms": core["lat_cold_ms"],
                "b1_dispatch_p99_ms": core["lat_cold_p99_ms"]} if core.get("lat_cold_ms") else {}),
            **extras,
        },
    }), flush=True)


def _full_run_summary(path):
    """A summary of the port's training curve (`cli/train_full.py`'s JSON),
    or None when it cannot be read: a curve the trainer is rewriting must
    never stop the headline line."""
    try:
        with open(path) as f:
            d = json.load(f)
        tot = d.get("total_loss") or []
        return {
            "path": str(path),
            "iters_done": d.get("iters_done"),
            "iters_target": d.get("iters_target"),
            "completed": d.get("completed"),
            "dtype": d.get("dtype"),
            "wall_h": round(float(d.get("wall_s", 0.0)) / 3600.0, 2),
            "iters_per_s": round(float(d.get("iters_per_s", 0.0)), 1),
            "loss_start": round(float(tot[0]), 4) if tot else None,
            "loss_final": round(float(tot[-1]), 4) if tot else None,
        }
    except Exception:
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true",
                    help="8 joints and narrow widths: a rehearsal, with --device cpu only")
    ap.add_argument("--quick", action="store_true",
                    help="a depth cut at full width: core at B=64 and 5 B=1 runs, 4 serving "
                         "requests, a 5 s stream, 3 train replays a dtype")
    ap.add_argument("--full-run-curve", default=None,
                    help="the curve JSON of a port's training run (cli/train_full.py)")
    ap.add_argument("--root", default=str(FX.CORPUS_ROOT),
                    help="the serving corpus's directory (kept between runs)")
    args = ap.parse_args(argv)
    if args.tiny and args.device != "cpu":
        ap.error("--tiny is a rehearsal on the CPU: add --device cpu (a card runs the v1 width)")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("error: no CUDA device is available (a rehearsal on the CPU takes "
                  "--device cpu)", file=sys.stderr)
            return 1
        from ..ops.kernels import build

        build.build_all()  # once, before any stage's process looks for the libraries

    budget_s = float(os.environ.get("ZEGGS_BENCH_BUDGET_S", "1140"))
    t_start = time.time()

    def remaining():
        return budget_s - (time.time() - t_start)

    depth = 1 if args.quick else 0
    common = ["--device", args.device] + (["--tiny"] if args.tiny else [])
    stages = []
    for key, module, full, quick, budgeted, gate in STAGES:
        if os.environ.get(gate, "1") == "0":
            continue
        stage_args = common + (quick if args.quick else full)
        if budgeted:  # the serving stages, which share the corpus under --root
            stage_args += ["--root", args.root]
        stages.append((key, _stage(module, *stage_args), ESTIMATES[key][depth], budgeted))

    t_core = time.time()
    core_argv = _stage("core", *common, *(["--batches", "64", "--b1-runs", "5"]
                                          if args.quick else []))
    core_timeout = max(float(ESTIMATES["core"][depth]),
                       remaining() - 20.0 - sum(est for _, _, est, _ in stages))
    try:
        core = _run_stage(core_argv, timeout=core_timeout)
    except Exception as e:
        print(f"# core stage failed: {e}", file=sys.stderr)
        core = {**getattr(e, "partial", {}), "failed": str(e)[:300]}
    # headline first: everything after this only enriches it
    extras = {"core_wall_s": round(time.time() - t_core, 1),
              "device": FX.device_summary(args.device)}
    if args.device == "cpu":
        extras["rehearsal"] = True
    if args.full_run_curve:
        fr = _full_run_summary(args.full_run_curve)
        if fr:
            extras["full_run"] = fr
    extras["core"] = core
    _emit(core, extras)

    for i, (key, argv, est, budgeted) in enumerate(stages):
        if remaining() < est:
            extras[key] = {"skipped_over_budget": True, "remaining_s": round(remaining(), 1)}
            print(f"# stage {key} skipped: {remaining():.0f}s budget left < {est}s estimate",
                  file=sys.stderr)
            _emit(core, extras)
            continue
        try:
            t_stage = time.time()
            stage_timeout = max(60.0, remaining() - 20.0)
            # the later stages' estimates stay in reserve: a stage that runs
            # away costs at most itself
            later_est = sum(e for _, _, e, _ in stages[i + 1:])
            if budgeted:
                stage_budget = max(est, stage_timeout - 15.0 - later_est)
                # the stage's watchdog (budget + 5 s) must fire before its
                # process is killed, or its partial line is lost
                stage_budget = min(stage_budget, stage_timeout - 10.0)
                stage_timeout = min(stage_timeout, stage_budget + 30.0)
                argv = argv + ["--budget", str(round(stage_budget, 1))]
            else:
                stage_timeout = min(stage_timeout, max(est, stage_timeout - later_est))
            extras[key] = _run_stage(argv, timeout=stage_timeout)
            # what the stage cost, for the estimates above
            extras[key]["stage_wall_s"] = round(time.time() - t_stage, 1)
        except Exception as e:
            print(f"# {key} stage failed: {e}", file=sys.stderr)
            extras[key] = {**getattr(e, "partial", {}), "failed": str(e)[:300]}
        _emit(core, extras)
    failed = [k for k, v in extras.items() if isinstance(v, dict) and "failed" in v]
    if failed:
        print(f"# failed: {', '.join(failed)}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
