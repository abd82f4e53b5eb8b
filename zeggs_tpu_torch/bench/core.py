"""The bench's core stage: batched frames/s, int8 frames/s and B=1 latencies
(counterpart of `bench.py`'s ``make_synthesis_fn``, ``bench`` and
``stage_core``).

    python -m zeggs_tpu_torch.bench.core [--batches 64,256,1024,2048]

Batched: the speech encoder, then `infer/programs.py::ProgramCache.rollout`
(the decoder steps replayed from CUDA graphs, GRU1 through the GRU-cell
kernel) on random features of a 10 s clip, B clips at once; the median of
4 timed runs after 2 warm ones. ``fps8`` runs the same with
products on int8 values, at B >= `infer.generate.INT8_BATCHED_MIN` (the
smallest batch the pipeline runs int8 at). B=1: the speech encoder, then
`models/decoder.py::make_fused_b1_fn` (one launch of the decoder kernel)
at bfloat16 and at int8 weights; ``lat_cold_ms`` / ``lat_cold_p99_ms`` are
the p50 / p99 of 20 single dispatches of a new function. Every timed run
ends in `torch.cuda.synchronize()`.

Correctness, once and before the timed runs: the B=1 kernel at float32
weights against its plain version (`ops/kernels/decoder_rollout.py::
rollout_b1_plain`, MAE < 1e-3), and one batched chunk's graphed rows
against the eager `models.decoder.rollout` (MAE <= 1e-6). Prints one JSON
line; exits 1 if a check fails or if a kernel of the path was not launched.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..infer.generate import INT8_BATCHED_MIN
from ..infer.programs import OUTPUTS, ProgramCache
from ..models import decoder
from ..models import pose as P
from ..ops.kernels import build
from ..ops.kernels import decoder_rollout as DR
from ..train.loop import init_networks
from . import fixture as FX

#: B of the batched frames/s: the winner of one sweep over B in {64, 256,
#: 1024, 2048} on an NVIDIA H100 80GB HBM3 at 700 W, which read 221,957,
#: 459,441, 648,699 and 723,850 frames/s (PERF.md section 5)
BATCH = 2048
SECONDS = 10.0
TINY_BATCH, TINY_SECONDS = 8, 2.0
WARMUP, ITERS = 2, 4
B1_RUNS, COLD_RUNS = 10, 20
#: the B=1 kernel at float32 weights against its plain version: pose MAE
B1_MAE = 1e-3
#: graphed against eager batched rows: MAE (PERF.md section 2)
GRAPH_MAE = 1e-6
#: the kernels the stage's path must launch on a card
REQUIRED = ("decoder_rollout", "decoder_step", "gru_cell")


class Model:
    """The three networks at a width (random weights from seed 0), the
    `fixture._stats` statistics and the decoder's rollout programs on one
    device, for inference."""

    def __init__(self, w: FX.Width, device):
        self.device, self.njoints = device, w.njoints
        self.style_size = w.options.net.style_encoder.style_encoding_size
        self.nets = {k: m.eval().requires_grad_(False) for k, m in
                     init_networks(w.options, w.dims, nlabels=19, seed=0, device=device).items()}
        self.stats = {k: torch.as_tensor(v, device=device)
                      for k, v in FX._stats(w.pose_in, w.pose_out).items()}
        self.programs = ProgramCache(self.nets["decoder"], self.stats, FX.DT)

    def pose_stats(self):
        s = self.stats
        return (s["anim_input_mean"], s["anim_input_std"], s["anim_output_mean"],
                s["anim_output_std"])

    def inputs(self, rng, batch, seconds):
        """(audio, gaze, style, state0) of ``batch`` random clips."""
        T = int(seconds * 60)
        state0 = FX._initial_state(rng, batch, self.njoints)
        audio = rng.normal(size=(batch, T, FX.AUDIO_DIM)).astype(np.float32)
        gaze = rng.normal(size=(batch, T, 3)).astype(np.float32)
        style = rng.normal(size=(batch, T, self.style_size)).astype(np.float32)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        return dev(audio), dev(gaze), dev(style), tuple(dev(s) for s in state0)


def make_synthesis_fn(model: Model, fused_b1=False, chain=1, fused_dtype=torch.bfloat16,
                      quantize_int8=False):
    """fn(audio, gaze, style, state0): the speech encoder, then the decoder
    kernel at B=1 (``fused_b1``, weights of ``fused_dtype``) or the rollout
    programs. ``chain`` > 1 runs that many rollouts back to back, each from
    the last frame of the one before: `bench.py` chained 10 to hide a TPU
    link's dispatch cost, which a card attached to its host does not have,
    so the card runs ``chain=1``; only the B=1 kernel, which returns every
    state trajectory, can chain."""
    fused = None
    if fused_b1:
        fused = decoder.make_fused_b1_fn(model.nets["decoder"], *model.pose_stats(), FX.DT,
                                         weights_dtype=fused_dtype)
    if chain > 1 and fused is None:
        raise ValueError("only the B=1 kernel's rollouts chain")

    def one(audio, gaze, style, state0):
        speech = model.nets["speech_encoder"](audio)
        if fused is not None and speech.shape[0] == 1:
            return fused(state0, gaze, speech, style)
        return model.programs.rollout(state0, gaze, speech, style, quantize_int8)

    def fn(audio, gaze, style, state0):
        if chain == 1:
            out = one(audio, gaze, style, state0)
            return tuple(out[i] for i in OUTPUTS) if len(out) > 4 else out
        s = state0
        for _ in range(chain):
            out = one(audio, gaze, style, s)
            s = tuple(o[:, -1] for o in out)
        return s

    return fn


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(model: Model, inputs, fn, iters, warmup=WARMUP, chain=1):
    """``warmup`` untimed calls, then ``iters`` calls each closed by a
    synchronize -> (frames/s at the median, median seconds a rollout, the
    seconds of each call)."""
    for _ in range(warmup):
        fn(*inputs)
    _sync(model.device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*inputs)
        _sync(model.device)
        times.append(time.perf_counter() - t0)
    t_med = float(np.median(times)) / chain
    B, T = inputs[0].shape[:2]
    return B * T / t_med, t_med, times


def b1_kernel_args(model: Model, packed, inputs):
    """The decoder kernel's arguments for one clip, as
    `decoder_rollout.rollout_fused_b1` builds them (the speech encoder and
    the cell-state encoder first)."""
    audio, gaze, style, state0 = inputs
    dec = model.nets["decoder"]
    mean, std = model.pose_stats()[:2]
    speech = model.nets["speech_encoder"](audio)
    pose0 = P.vectorize_input(*state0, gaze[:, 0], mean, std)
    h = decoder.cell_state_encoder(dec.cell_state_encoder, pose0, style[:, 0])
    cond_l0, cond_g0 = DR.conditioning(packed, speech, style)
    root_pos, root_rot, *rest = state0
    p0 = torch.cat([x.reshape(-1) for x in rest])
    root0 = torch.cat([root_pos[0], root_rot[0]])
    return (cond_l0, cond_g0, gaze[0, 1:].contiguous(), p0.float().contiguous(),
            h[:, 0].float().contiguous(), root0.float().contiguous())


def check(model: Model, batch, seconds):
    """The stage's two correctness checks -> (all passed, readings)."""
    rng = np.random.default_rng(2)
    packed = DR.pack_decoder(model.nets["decoder"].cell, *model.pose_stats(), torch.float32)
    args = b1_kernel_args(model, packed, model.inputs(rng, 1, seconds))
    kernel = DR.rollout_b1(packed, *args, FX.DT)
    plain = DR.rollout_b1_plain(packed, *args, FX.DT)
    b1_mae = (kernel - plain).abs().mean().item()

    audio, gaze, style, state0 = model.inputs(rng, batch, seconds)
    speech = model.nets["speech_encoder"](audio)
    graphed = model.programs.rollout(state0, gaze, speech, style)
    eager = decoder.rollout(model.nets["decoder"], *state0, gaze, speech, style,
                            *model.pose_stats(), FX.DT, output_indices=OUTPUTS)
    diffs = [(g - e).abs() for g, e in zip(graphed, eager)]
    graph_mae = max(d.mean().item() for d in diffs)
    readings = {"b1_kernel_vs_plain_mae": b1_mae, "b1_tol": B1_MAE,
                "batched_graphs_vs_eager_mae": graph_mae,
                "batched_graphs_vs_eager_max_abs": max(d.max().item() for d in diffs),
                "graphs_tol": GRAPH_MAE, "batched_rows": batch}
    return bool(b1_mae < B1_MAE and graph_mae <= GRAPH_MAE), readings


def main(argv=None):
    ap = FX.stage_parser(__doc__.splitlines()[0])
    ap.add_argument("--batches", default=None,
                    help=f"batch sizes to time, comma-separated (default {BATCH}; "
                         f"{TINY_BATCH} with --tiny)")
    ap.add_argument("--b1-runs", type=int, default=B1_RUNS, help="timed B=1 runs (at least 5)")
    args, device = FX.parse_stage_args(ap, argv)
    if args.b1_runs < 5:
        ap.error("--b1-runs must be at least 5")
    batches = ([int(b) for b in args.batches.split(",")] if args.batches
               else [TINY_BATCH if args.tiny else BATCH])
    seconds = TINY_SECONDS if args.tiny else SECONDS
    with torch.inference_mode():
        result = run(FX.width(args.tiny), device, batches, seconds, args.b1_runs)
    FX.emit(result)
    missing = FX.missing_launches(result["launches"], REQUIRED, device)
    if missing:
        FX.log(f"core: no launch of {missing} on the card")
    return 0 if result["correct"] and not missing else 1


def run(w: FX.Width, device, batches, seconds, b1_runs):
    model = Model(w, device)
    correct, checks = check(model, min(batches), seconds)
    FX.log(f"core checks: {checks} -> {'pass' if correct else 'FAIL'}")
    before = build.launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    sweep = []
    rng = np.random.default_rng(0)
    for b in batches:
        inputs = model.inputs(rng, b, seconds)
        fps, t, times = bench(model, inputs, make_synthesis_fn(model), ITERS)
        sweep.append({"batch": b, "fps": fps, "s_per_batch": t, "times_s": times})
        FX.log(f"batch={b}: {fps:,.0f} frames/s ({t:.3f} s per {b} x {seconds:g} s batch)")
        del inputs
    best = max(sweep, key=lambda r: r["fps"])
    b8 = max(best["batch"], INT8_BATCHED_MIN)
    inputs = model.inputs(rng, b8, seconds)
    fps8, t8, _ = bench(model, inputs, make_synthesis_fn(model, quantize_int8=True), ITERS)
    FX.log(f"batch={b8} int8: {fps8:,.0f} frames/s ({t8:.3f} s per batch)")
    del inputs

    b1 = model.inputs(np.random.default_rng(0), 1, seconds)
    _, lat, _ = bench(model, b1, make_synthesis_fn(model, fused_b1=True), b1_runs)
    _, lat8, _ = bench(model, b1, make_synthesis_fn(model, fused_b1=True,
                                                    fused_dtype=torch.int8), b1_runs)
    FX.log(f"B=1 latency a {seconds:g} s clip: bf16 {lat * 1e3:.2f} ms, int8 {lat8 * 1e3:.2f} ms")
    # single dispatches of a new function: p50 / p99
    cold = model.inputs(np.random.default_rng(1), 1, seconds)
    fn1 = make_synthesis_fn(model, fused_b1=True)
    _, _, cold_times = bench(model, cold, fn1, COLD_RUNS, warmup=1)
    lat_cold, lat_cold_p99 = (float(np.percentile(cold_times, q)) for q in (50, 99))
    FX.log(f"B=1 single dispatches: p50 {lat_cold * 1e3:.2f} ms, p99 {lat_cold_p99 * 1e3:.2f} ms")
    launches = build.launches_since(before)

    return {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "best_fps": best["fps"],
        "fps8": fps8,
        "lat_ms": lat * 1e3,
        "lat8_ms": lat8 * 1e3,
        "lat_cold_ms": lat_cold * 1e3,
        "lat_cold_p99_ms": lat_cold_p99 * 1e3,
        "batch": best["batch"], "fps8_batch": b8, "seconds_clip": seconds, "chain": 1,
        "best_fps_n": ITERS, "fps8_n": ITERS, "lat_n": b1_runs, "lat8_n": b1_runs,
        "lat_cold_n": COLD_RUNS, "sweep": sweep,
        "max_memory_mib": (torch.cuda.max_memory_allocated(device) / 2**20
                           if device.type == "cuda" else None),
        "correct": correct, "checks": checks,
        "launches": launches, "device": FX.device_summary(device),
    }


if __name__ == "__main__":
    sys.exit(main())
