"""The bench's serve stage: the CSV-batch path end to end at full ZEGGS
scale (counterpart of `scripts/bench_serve.py`).

    python -m zeggs_tpu_torch.bench.serve --requests 20 --daemon [--budget S]

Replays a synthetic 20-request corpus (`fixture.build_corpus`) through the
serving modes, in priority order:
  * warmup: `infer.batch.warmup` captures every rollout program and
    finish graph the run will replay (bucket 256, chunks of 32; with
    ``--daemon`` every power-of-two batch too), so no capture falls inside
    a timed pass;
  * batched: `infer.batch.generate_batch`, a first pass, then the median
    of 3 warm passes;
  * daemon (``--daemon``): `serve.GestureServer(max_batch=32,
    max_wait_ms=50, bucket=256)` on 127.0.0.1, every request POSTed at once:
    one warm pass, then 3 timed; p50/p99 latency, mean batch size and the
    rejected, timeout and error totals;
  * sequential: `generate_gesture` a request at a time (the B=1 decoder
    kernel), a pass that captures nothing new, then the measured pass; if
    the budget skips the second, the first's percentiles are reported under
    ``seq_cold_`` keys, never under ``seq_``.

Everything is measured end to end: WAV read + mel featurization (the mel
kernel) + style-BVH features + rollout + BVH writing. Prints one JSON line,
also when the watchdog cuts the run at budget + 5 s (``watchdog_fired``,
exit code 0). A phase that raises is recorded (``daemon_failed``,
``seq_failed``) and the stage exits 1 after printing, as it does when a
kernel of the path was not launched on the card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..infer.batch import _round_up, generate_batch, plan_programs, warmup
from ..infer.generate import GesturePipeline, generate_gesture
from . import fixture as FX

#: the kernels the stage's path must launch on a card: the mel kernel a
#: request, the GRU cell and the step's kernels in batched chunks, the
#: decoder at B=1
REQUIRED = ("decoder_rollout", "decoder_step", "gru_cell", "mel_spectrogram")


def main(argv=None):
    ap = FX.stage_parser(__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--root", type=str, default=str(FX.CORPUS_ROOT))
    ap.add_argument("--skip-sequential", action="store_true")
    ap.add_argument("--daemon", action="store_true",
                    help="also benchmark the HTTP daemon (serve/): all requests fired as "
                         "concurrent POSTs through the dynamic micro-batcher")
    ap.add_argument("--warm-only", action="store_true",
                    help="only run the warmup phase (capture every program this bench would "
                         "replay), print its JSON, and exit")
    ap.add_argument("--budget", type=float, default=0.0,
                    help="wall-clock budget in seconds (0 = unbounded). Phases run in priority "
                         "order (warmup -> batched -> daemon -> sequential); a phase whose "
                         "estimated cost exceeds the remaining budget is skipped and marked in "
                         "the JSON line, which is always printed: a watchdog thread prints the "
                         "partial JSON and exits 0 at budget + 5 s")
    args, device = FX.parse_stage_args(ap, argv)
    t_main = time.perf_counter()

    def remaining():
        return (args.budget - (time.perf_counter() - t_main)) if args.budget else float("inf")

    result = {}
    finished = FX.start_watchdog(args.budget, result, t_main)
    result["phase"] = "corpus"  # watchdog partials say where the cut hit
    result["device"] = FX.device_summary(device)
    t0 = time.perf_counter()
    net_dir, data_dir, requests, total_frames, opts, lengths = FX.build_corpus(
        Path(args.root), args.requests, tiny=args.tiny)
    result["corpus_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    pipe = GesturePipeline(net_dir, data_dir, options=opts, device=device)
    result["pipe_init_s"] = round(time.perf_counter() - t0, 1)
    FX.log(f"corpus: {result['corpus_s']}s, pipeline init: {result['pipe_init_s']}s")
    counts = FX.PhaseCounts()
    result["launches"] = counts.total
    result["launches_by_phase"] = counts.by_phase
    result["phase"] = "warmup"
    with torch.inference_mode():
        failed = _phases(args, result, counts, pipe, net_dir, data_dir, requests, total_frames,
                         lengths, remaining)
    result["phase"] = "done"
    finished.set()
    FX.emit(result)
    missing = FX.missing_launches(counts.total, REQUIRED, device)
    if missing and not args.warm_only:
        FX.log(f"serve: no launch of {missing} on the card")
        failed = True
    return 1 if failed else 0


def _phases(args, result, counts, pipe, net_dir, data_dir, requests, total_frames, lengths,
            remaining):
    """The phases after the pipeline's load -> whether one failed."""
    # ---- warmup: capture every program this bench will replay, one at a
    # time, leaving a measurement reserve ----------------------------------
    reserve_s = 0.0 if args.warm_only else 90.0
    deadline = (time.monotonic() + max(5.0, remaining() - reserve_s)
                if args.budget else None)
    t0 = time.perf_counter()
    warm = warmup(
        pipe, lengths, bucket=256, max_batch=32,
        all_pow2=args.daemon or args.warm_only,
        style_jobs=[(256, len(requests))],
        deadline=deadline,
        log=FX.log,
    )
    counts.close("warmup")
    result["warmup_s"] = round(time.perf_counter() - t0, 1)
    result["warmup_programs"] = len(warm["compiled"])
    result["warmup_complete"] = warm["complete"]
    FX.log(f"warmup: {result['warmup_s']}s, {len(warm['compiled'])} programs"
           f" ({'complete' if warm['complete'] else 'cut off'})")
    if args.warm_only:
        return False

    # keep the requests whose whole length bucket was captured: dropping
    # whole buckets keeps the survivors' chunks (and their programs' shapes)
    # those that were warmed
    if not warm["complete"]:
        compiled = set(warm["compiled"])
        plan_by_t = {}
        for t, b in plan_programs(lengths, bucket=256, max_batch=32):
            plan_by_t.setdefault(t, []).append((t, b))
        ok_t = {t for t, progs in plan_by_t.items() if all(p in compiled for p in progs)}
        kept = [(req, n) for req, n in zip(requests, lengths)
                if max(256, _round_up(n, 256)) in ok_t]
        result["requests_dropped_cold"] = len(requests) - len(kept)
        FX.log(f"warmup cut off: dropping {result['requests_dropped_cold']} request(s) in "
               "buckets not captured")
        requests = [r for r, _ in kept]
        total_frames = sum(n for _, n in kept)
        if not requests:
            result["failed"] = "no serving bucket captured within budget"
            return True

    # ---- batched serving path ---------------------------------------------
    result["phase"] = "batched"
    out_b = Path(args.root) / "out_batched"
    t0 = time.perf_counter()
    written = generate_batch(pipe, requests, out_b, bucket=256, max_batch=32)
    makespan = time.perf_counter() - t0
    FX.log(f"batched first pass: {makespan:.1f}s")
    if len(written) != len(requests):
        raise RuntimeError(f"generate_batch wrote {len(written)} of {len(requests)} requests")
    warm_spans = []
    n_warm = 3 if remaining() > 6 * makespan else 1
    for _ in range(n_warm):
        t0 = time.perf_counter()
        generate_batch(pipe, requests, out_b, bucket=256, max_batch=32)
        warm_spans.append(time.perf_counter() - t0)
    counts.close("batched")
    makespan_warm = float(np.median(warm_spans))
    result.update({
        "n_requests": len(requests),
        "total_frames": total_frames,
        "serve_clips_per_s": round(len(requests) / makespan_warm, 3),
        "serve_frames_per_s": round(total_frames / makespan_warm, 1),
        "batched_makespan_s": round(makespan_warm, 3),
        "batched_makespan_n": len(warm_spans),
        "batched_makespan_first_s": round(makespan, 3),
    })
    failed = False

    # ---- HTTP daemon (dynamic micro-batching): before sequential, since its
    # p50/p99 under load is the headline and sequential a comparison --------
    daemon_first = makespan_warm if warm["complete"] else makespan
    if args.daemon and remaining() < daemon_first + 4 * makespan_warm + 15:
        FX.log(f"daemon phase skipped: {remaining():.0f}s left")
        result["daemon_skipped_over_budget"] = True
        args.daemon = False
    if args.daemon:
        result["phase"] = "daemon"
        failed |= _daemon(result, pipe, requests, makespan_warm, remaining)
        counts.close("daemon")

    # ---- sequential replay (a request at a time; lowest priority) ---------
    seq_est = (3 * makespan_warm if warm["complete"] else 2 * makespan) + 10
    if not args.skip_sequential and remaining() < seq_est:
        FX.log(f"sequential phase skipped: {remaining():.0f}s left")
        result["seq_skipped_over_budget"] = True
        args.skip_sequential = True
    if not args.skip_sequential:
        result["phase"] = "sequential"
        failed |= _sequential(result, pipe, requests, net_dir, data_dir,
                              Path(args.root) / "out_seq", remaining)
        counts.close("sequential")
    return failed


def _daemon(result, pipe, requests, makespan_warm, remaining):
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from ..serve.server import GestureServer

    srv = GestureServer(pipe, max_batch=32, max_wait_ms=50, bucket=256)
    port = srv.start()
    payloads = [
        json.dumps({
            "audio_path": str(req.audio),
            "styles": [{"bvh_path": str(req.styles[0][0]), "frames": list(req.styles[0][1])}],
            "seed": req.seed, "file_name": req.file_name,
        }).encode()
        for req in requests
    ]

    def post(body):
        t0 = time.perf_counter()
        r = urllib.request.urlopen(
            urllib.request.Request(f"http://127.0.0.1:{port}/synthesize", data=body,
                                   headers={"Content-Type": "application/json"}),
            timeout=1800,
        )
        out = json.loads(r.read())
        return time.perf_counter() - t0, out["batch_size"], len(out["bvh"])

    def one_pass():
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(payloads)) as pool:
            outs = list(pool.map(post, payloads))
        return time.perf_counter() - t0, outs

    try:
        t0 = time.perf_counter()
        one_pass()  # warm: the daemon's own style-encoder batches may be new
        FX.log(f"daemon warm pass: {time.perf_counter() - t0:.1f}s")
        spans, all_lat, all_bs = [], [], []
        for _ in range(3 if remaining() > 6 * makespan_warm else 1):
            span, outs = one_pass()
            spans.append(span)
            all_lat.extend(o[0] for o in outs)
            all_bs.extend(o[1] for o in outs)
        lat = np.asarray(all_lat)
        result["daemon_makespan_s"] = round(float(np.median(spans)), 3)
        result["daemon_makespan_n"] = len(spans)
        result["daemon_clips_per_s"] = round(len(requests) / float(np.median(spans)), 3)
        result["daemon_p50_s"] = round(float(np.percentile(lat, 50)), 3)
        result["daemon_p99_s"] = round(float(np.percentile(lat, 99)), 3)
        result["daemon_latency_n"] = len(lat)
        result["daemon_batch_size_mean"] = round(float(np.mean(all_bs)), 2)
        snap = srv.stats.snapshot()
        result["daemon_rejected_total"] = snap["rejected_total"]
        result["daemon_timeouts_total"] = snap["timeouts_total"]
        result["daemon_errors_total"] = snap["errors_total"]
        return False
    except Exception as e:  # still emit every number measured so far
        FX.log(f"daemon phase failed: {e!r}")
        result["daemon_failed"] = str(e)[:200]
        return True
    finally:
        srv.stop()


def _sequential(result, pipe, requests, net_dir, data_dir, out_s, remaining):
    t0 = time.perf_counter()
    try:
        # the first pass loads what a request touches; the second measures
        for ipass in range(2):
            lat = []
            for req in requests:
                t0r = time.perf_counter()
                generate_gesture(
                    req.audio, req.styles, network_path=net_dir, data_path=data_dir,
                    results_path=out_s, temperature=req.temperature, seed=req.seed,
                    file_name=req.file_name, pipeline=pipe,
                )
                lat.append(time.perf_counter() - t0r)
            if ipass == 0 and remaining() < sum(lat) + 5:
                FX.log(f"sequential warm pass skipped: {remaining():.0f}s left")
                result["seq_warm_skipped_over_budget"] = True
                break
        lat = np.asarray(lat)
        # the first pass's latencies are another population than the warm
        # pass's: they go under distinct keys
        pre = "seq_cold_" if result.get("seq_warm_skipped_over_budget") else "seq_"
        result[pre + "p50_s"] = round(float(np.percentile(lat, 50)), 3)
        result[pre + "p95_s"] = round(float(np.percentile(lat, 95)), 3)
        result[pre + "p99_s"] = round(float(np.percentile(lat, 99)), 3)
        result[pre + "n"] = len(lat)
        result[pre + "clips_per_s"] = round(len(lat) / float(lat.sum()), 3)
        failed = False
    except Exception as e:
        FX.log(f"sequential phase failed: {e!r}")
        result["seq_failed"] = str(e)[:200]
        failed = True
    FX.log(f"sequential phase: {time.perf_counter() - t0:.1f}s")
    return failed


if __name__ == "__main__":
    sys.exit(main())
