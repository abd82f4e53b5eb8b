"""The bench's streaming stage: a live session's latency on the card
(counterpart of `scripts/bench_streaming.py`).

    python -m zeggs_tpu_torch.bench.streaming --seconds 30 --push-ms 500 --quantum 16 [--http]

Simulates a live feed into the v1 model: ``--seconds`` of synthetic speech
pushed in ``--push-ms`` chunks into `GesturePipeline.streaming_session`
(the mel kernel on each push's audio; the decoder's chunks replayed from the
rollout programs, GRU1 through the GRU-cell kernel, ``--quantum`` frames at
least a chunk). A cold session (which captures the programs), then a warm
one, which gives the numbers: time to the first gesture frame, push
latency p50/p95 (a push must take less than its audio for realtime), the
finish and the realtime factor. ``--http`` streams the same feed through
the daemon's /stream endpoints and reports what its client sees. Prints
one JSON line, also when the watchdog cuts the run at budget + 5 s
(``watchdog_fired``, exit code 0); exits 1 if a kernel of the path was not
launched on the card.
"""

from __future__ import annotations

import base64
import json
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

from ..infer.generate import GesturePipeline
from . import fixture as FX

#: the kernels the stage's path must launch on a card
REQUIRED = ("decoder_step", "gru_cell", "mel_spectrogram")


def _latencies(lats, frames, total, ttff, finish):
    return dict(ttff_s=ttff, push_p50_s=float(np.percentile(lats, 50)),
                push_p95_s=float(np.percentile(lats, 95)), push_n=len(lats), finish_s=finish,
                total_s=total, frames=frames, realtime_factor=(frames / 60.0) / total)


def run_session(pipe, style, audio, push, quantum):
    sess = pipe.streaming_session([style], temperature=1.0, seed=1, quantum=quantum)
    t0 = time.perf_counter()
    ttff = None
    lats = []
    for o in range(0, len(audio), push):
        t1 = time.perf_counter()
        new = sess.push(audio[o : o + push])
        lats.append(time.perf_counter() - t1)
        if ttff is None and new["root_pos"].shape[0] and sess.frames_emitted > 1:
            ttff = time.perf_counter() - t0
    t1 = time.perf_counter()
    sess.finish()
    finish_lat = time.perf_counter() - t1
    return _latencies(lats, sess.frames_emitted, time.perf_counter() - t0, ttff, finish_lat)


def run_http_session(pipe, style, audio, push, quantum):
    """The same feed through the daemon's /stream endpoints: what a network
    client of the daemon sees (HTTP, base64 and the scheduler's queue on
    top of the session)."""
    from ..serve.server import GestureServer

    srv = GestureServer(pipe, max_batch=8, max_wait_ms=10)
    port = srv.start()

    def post(path, payload):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())

    try:
        style_bvh, style_frames = style
        entry = {"bvh_b64": base64.b64encode(Path(style_bvh).read_bytes()).decode()}
        if style_frames is not None:  # the same example shape: the same programs
            entry["frames"] = list(style_frames)
        t0 = time.perf_counter()
        out = post("/stream/start", {"styles": [entry], "seed": 1, "quantum": quantum})
        sid = out["session_id"]
        ttff = None
        lats = []
        frames = out["frames"]["n"]
        for o in range(0, len(audio), push):
            chunk = np.asarray(audio[o : o + push], "<f4")
            t1 = time.perf_counter()
            r = post("/stream/push", {
                "session_id": sid,
                "audio_f32_b64": base64.b64encode(chunk.tobytes()).decode()})
            lats.append(time.perf_counter() - t1)
            frames += r["frames"]["n"]
            if ttff is None and frames > 1:
                ttff = time.perf_counter() - t0
        t1 = time.perf_counter()
        fin = post("/stream/finish", {"session_id": sid})
        finish_lat = time.perf_counter() - t1
        frames += fin["frames"]["n"]
        return _latencies(lats, frames, time.perf_counter() - t0, ttff, finish_lat)
    finally:
        srv.stop()


def _rounded(d):
    return {k: (round(v, 4) if isinstance(v, float) else v) for k, v in d.items()}


def main(argv=None):
    ap = FX.stage_parser(__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--push-ms", type=float, default=500.0)
    ap.add_argument("--quantum", type=int, default=16)
    ap.add_argument("--http", action="store_true",
                    help="also drive the daemon's /stream endpoints and report the "
                         "client-observed numbers")
    ap.add_argument("--root", type=str, default=str(FX.CORPUS_ROOT))
    ap.add_argument("--budget", type=float, default=0.0,
                    help="wall-clock budget in seconds (0 = unbounded): a watchdog thread "
                         "prints the partial JSON and exits 0 at budget + 5 s")
    args, device = FX.parse_stage_args(ap, argv)
    t_main = time.perf_counter()

    def remaining():
        return (args.budget - (time.perf_counter() - t_main)) if args.budget else float("inf")

    r = {"phase": "corpus", "device": FX.device_summary(device)}
    finished = FX.start_watchdog(args.budget, r, t_main)
    t0 = time.perf_counter()
    net_dir, data_dir, requests, _, opts, _ = FX.build_corpus(Path(args.root), n_requests=1,
                                                              tiny=args.tiny)
    r["corpus_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    pipe = GesturePipeline(net_dir, data_dir, options=opts, device=device)
    r["pipe_init_s"] = round(time.perf_counter() - t0, 1)
    FX.log(f"corpus: {r['corpus_s']}s, pipeline init: {r['pipe_init_s']}s")
    style = requests[0].styles[0]

    sr = pipe.mel_cfg.sampling_rate
    audio = FX.speech_like(np.random.default_rng(0), int(args.seconds * sr), sr)
    push = int(args.push_ms / 1e3 * sr)
    counts = FX.PhaseCounts()
    r["launches"] = counts.total
    r["launches_by_phase"] = counts.by_phase

    with torch.inference_mode():
        # the cold session captures the session's programs; the warm one is
        # the number
        r["phase"] = "cold_session"
        t0 = time.perf_counter()
        run_session(pipe, style, audio, push, args.quantum)
        cold_s = time.perf_counter() - t0
        counts.close("cold_session")
        FX.log(f"cold session: {cold_s:.1f}s")
        r["phase"] = "warm_session"
        r.update(_rounded(run_session(pipe, style, audio, push, args.quantum)))
        counts.close("warm_session")
        r.update(seconds=args.seconds, push_ms=args.push_ms, quantum=args.quantum,
                 cold_session_s=round(cold_s, 1))
        # the HTTP session shares this process's pipeline and programs, so it
        # costs about the warm session plus the server's overhead
        if args.http and remaining() < 1.5 * r["total_s"] + 15:
            FX.log(f"http phase skipped: {remaining():.0f}s left")
            r["http_skipped_over_budget"] = True
            args.http = False
    if args.http:
        r["phase"] = "http"
        r["http"] = _rounded(run_http_session(pipe, style, audio, push, args.quantum))
        counts.close("http")
    r["phase"] = "done"
    finished.set()
    FX.emit(r)
    missing = FX.missing_launches(counts.total, REQUIRED, device)
    if missing:
        FX.log(f"streaming: no launch of {missing} on the card")
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
