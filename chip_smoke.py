#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zeggs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (one nvcc per source, all at once),
writes a full-width v1 fixture made from a seed (75-joint skeleton, random
PyTorch-default weights, statistics, a style BVH and three WAVs of 4, 10
and 12 s) under build/chip_smoke/, then:

  1. checks each kernel against its plain PyTorch version at the main
     paths' shapes: the decoder rollout (one step and a 600-frame rollout,
     fp32, bf16 and int8 weights; int8 also against the fp32 kernel; with
     each plan's resident share), the GRU cell (B=1, 2, 3, 64 and 65 at
     1024/1024 and the JAX tests' shapes) and the mel spectrogram (the
     three clips, the streaming windows of 1 to 512 frames, an input
     shorter than n_fft and a zero window); times each against its plain
     version and its bound (bytes over 3.35 TB/s or operations over the
     operands' peak), the GRU cell at B=1, 2 and 64 also against
     torch.gru_cell (CUDA graphs, TF32 off), and the decoder's barrier
     floor: 599 x 4 grid barriers and nothing else, with the kernel's own
     barrier and with cooperative groups' grid sync;
  2. drives each path through the generate CLI over the three clips on the
     card, every launch count reset just before and read just after: CSV
     mode (3 bf16 decoder launches), `-b` (buckets of 512 frames: one B=1
     decoder launch and a B=2 chunk of 1023 GRU-cell launches, then
     batched against single requests at fp32 weights) and `--int8` (3 int8
     decoder launches); each path launches the mel kernel once a request;
  3. times single requests and a batch of 64 copies of the 10 s clip;
  4. compares a request on the card (fp32 rollout weights) with the same
     request on the CPU;
  5. streams the 10 s clip in 0.5 s pushes (quantum 16) through a session
     and holds its frames against the offline request (fp32 rollout
     weights); times the first frame, the pushes and the realtime factor;
  6. serves the pipeline on 127.0.0.1: four concurrent /synthesize
     requests that must share a batch, a stream over HTTP against an
     in-process session, and /healthz;
  7. prints times, each beside the card's name and power limit, a JSON
     line of launch counts, one of the barrier floor, one of kernel results
     and, last, {"ok": true, "device": {...}}.

Any failure ends the run with a nonzero exit and without the last line.
It exits nonzero at once when no CUDA device is available.
"""

from __future__ import annotations

import base64
import csv
import dataclasses
import json
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

SEED = 1234
ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
CLIPS = {"clip_04s": 4.0, "clip_10s": 10.0, "clip_12s": 12.0}
DT = 1.0 / 60.0

# kernel against plain: one step shares rounded inputs and differs only in
# the order of float32 sums; a whole rollout is held to the pose MAE budget
# of docs/DESIGN.md section 5
STEP_TOL = {"float32": 1e-4, "bfloat16": 1e-3, "int8": 1e-3}
ROLLOUT_MAE = 1e-3
CARD_VS_CPU_MAE = 1e-3
# int8 against fp32 weights: the bound of the JAX package's int8 tests,
# max error / max(1, max|fp32|)
INT8_VS_FP32 = 3e-2
# the GRU cell against its plain version (tests/test_pallas_kernels.py)
GRU_TOL = 2e-5
GRU_SHAPES = [(64, 1024, 1024), (2, 1024, 1024), (8, 384, 256), (16, 2304, 512),
              (1, 1024, 1024), (3, 1024, 1024), (65, 1024, 1024)]
GRU_TIMED = (1, 2, 64)  # batch sizes timed at in = H = 1024
# an H100 SXM's data-sheet peaks: HBM bytes/s and
# dense operations/s by the type of the operands
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
BATCH_COPIES = 64
# the mel spectrogram against its plain version (tests/test_pallas_kernels.py)
MEL_TOL = 2e-4
MEL_WINDOWS = (1, 2, 8, 32, 128, 512)
# a streaming session against the offline request at fp32 rollout weights:
# BVH positions (cm) and Euler angles (degrees), tests/test_streaming.py
STREAM_POS_MAE, STREAM_ROT_MAE = 1e-4, 1e-3
PUSH_SAMPLES = 8000  # 0.5 s
# frames over HTTP against the same session run in the process
HTTP_TOL = 1e-5


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# ---------------------------------------------------------------------------
# fixture
# ---------------------------------------------------------------------------

def skeleton(rng, njoints=75):
    """Hips -> Spine -> Spine1 -> Spine2 -> Neck -> Head, then chains of
    four joints hung from random earlier joints."""
    names = ["Hips", "Spine", "Spine1", "Spine2", "Neck", "Head"]
    parents = [-1, 0, 1, 2, 3, 4]
    while len(names) < njoints:
        p = int(rng.integers(0, len(names)))
        for _ in range(min(4, njoints - len(names))):
            names.append(f"Joint{len(names)}")
            parents.append(p)
            p = len(names) - 1
    return names, parents


def motion(rng, names, parents, nframes):
    J = len(names)
    t = np.linspace(0, 4 * np.pi, nframes)[:, None, None]
    rot = rng.uniform(5, 25, (1, J, 3)) * np.sin(t + rng.uniform(0, 2 * np.pi, (1, J, 3)))
    offsets = rng.uniform(-10, 10, (J, 3)).astype(np.float32)
    offsets[0] = 0
    pos = np.repeat(offsets[None], nframes, axis=0)
    pos[:, 0, 0] += np.linspace(0, 40, nframes)
    pos[:, 0, 1] += 90.0
    return {"rotations": rot.astype(np.float32), "positions": pos.astype(np.float32),
            "offsets": offsets, "parents": np.asarray(parents, np.int32), "names": names,
            "order": "zyx", "frametime": DT}


def speech_like(rng, seconds, fs=16000):
    t = np.arange(int(seconds * fs)) / fs
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / fs
    x = sum(np.sin(k * phase) / k for k in range(1, 8))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    x += 0.02 * rng.normal(size=t.shape)
    return (0.3 * x / np.abs(x).max()).astype(np.float32)


def write_fixture(torch):
    from zeggs_tpu_torch.config import Options
    from zeggs_tpu_torch.io import bvh, checkpoint, wav, weights
    from zeggs_tpu_torch.models.decoder import Decoder
    from zeggs_tpu_torch.models.speech_encoder import SpeechEncoder
    from zeggs_tpu_torch.models.style_encoder import StyleEncoder

    if WORK.exists():
        shutil.rmtree(WORK)
    data, models, results = WORK / "processed", WORK / "models", WORK / "results"
    for d in (data, models, results):
        d.mkdir(parents=True)
    rng = np.random.default_rng(SEED)
    names, parents = skeleton(rng)
    J = len(names)
    pose_in, pose_out = 6 + 15 * J + 3, 6 + 15 * J

    (data / "data_definition.json").write_text(json.dumps(
        {"dt": DT, "label_names": ["Neutral", "Happy", "Sad"], "parents": parents,
         "bone_names": names}))
    shutil.copy(ROOT / "configs" / "data_pipeline_conf_v1.json", data / "data_pipeline_conf.json")
    np.savez(data / "stats.npz",
             audio_input_mean=rng.normal(size=81).astype(np.float32),
             audio_input_std=rng.uniform(0.5, 2.0, 81).astype(np.float32),
             anim_input_mean=(rng.normal(size=pose_in) * 0.1).astype(np.float32),
             anim_input_std=rng.uniform(0.5, 5.0, pose_in).astype(np.float32),
             anim_output_mean=(rng.normal(size=pose_out) * 0.1).astype(np.float32),
             anim_output_std=rng.uniform(0.05, 0.5, pose_out).astype(np.float32))

    v1 = json.loads((ROOT / "configs" / "configs_v1.json").read_text())
    opts = Options.from_options_dict(v1).net
    torch.manual_seed(SEED)
    nets = {
        "speech_encoder": SpeechEncoder(81, opts.speech_encoder.nhidden,
                                        opts.speech_encoder.speech_encoding_size),
        "style_encoder": StyleEncoder(pose_in, opts.style_encoder.nhidden,
                                      opts.style_encoder.style_encoding_size, use_vae=True),
        "decoder": Decoder(pose_in, pose_out, opts.speech_encoder.speech_encoding_size,
                           opts.style_encoder.style_encoding_size, opts.decoder.nhidden,
                           opts.decoder.num_rnn_layers, opts.decoder.rnn_cond),
    }
    for name, module in nets.items():
        checkpoint.save(models / f"{name}.npz", weights.to_jax(module))

    v1["paths"] = {"base_path": str(WORK), "path_processed_data": "processed",
                   "output_dir": str(WORK), "models_dir": str(models)}
    (WORK / "options.json").write_text(json.dumps(v1, indent=2))

    bvh.save(WORK / "style.bvh", motion(rng, names, parents, 300))
    with open(WORK / "requests.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["base_path", "audio", "style", "file_name", "temperature", "seed",
                    "use_gpu", "frames", "first_pose", "generate"])
        for i, (clip, seconds) in enumerate(CLIPS.items()):
            wav.write_wavefile(WORK / f"{clip}.wav", speech_like(rng, seconds), 16000)
            w.writerow([str(WORK), f"{clip}.wav", "style.bvh", clip, "1.0", str(SEED + i),
                        "TRUE", "", "", "TRUE"])
    return results


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, kind):
    """(ms, "bytes" or "operations"): the least time an H100 could take to
    move `nbytes` (each input read once, each output written once) and do
    `ops` operations of `kind`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(torch, fn, calls=20, reps=20):
    """Device time of one call of `fn`: `calls` calls captured in one CUDA
    graph and replayed, so that the host's launch cost is not measured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    return event_ms(torch, graph.replay, reps) / calls


def rollout_inputs(torch, pipe, dtype, seconds_clip):
    """The kernel's inputs for one request at the main path's shapes, and
    its packed weights."""
    from zeggs_tpu_torch.models import decoder as D
    from zeggs_tpu_torch.models import pose as P
    from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR

    feats, n = pipe.audio_to_features(WORK / f"{seconds_clip}.wav")
    speech = pipe.encode_speech(feats)
    vec, f0 = pipe.style_example_from_bvh(WORK / "style.bvh")
    style = pipe.encode_style(vec, 0.0)[0][:, None].expand(-1, n, -1).contiguous()
    gaze = f0.gaze_pos[0].expand(n, 3)[None].contiguous()
    s = pipe.stats
    packed = DR.pack_decoder(pipe.networks["decoder"].cell, s["anim_input_mean"],
                             s["anim_input_std"], s["anim_output_mean"], s["anim_output_std"],
                             dtype)
    state0 = [getattr(f0, k)[0:1] for k in ("root_pos", "root_rot", "root_vel", "root_vrt",
                                             "lpos", "ltxy", "lvel", "lvrt")]
    pose0 = P.vectorize_input(*state0, gaze[:, 0], s["anim_input_mean"], s["anim_input_std"])
    dec = pipe.networks["decoder"]
    h = D.cell_state_encoder(dec.cell_state_encoder, pose0, style[:, 0])[:, 0].contiguous()
    cond_l0, cond_g0 = DR.conditioning(packed, speech, style)
    p0 = torch.cat([x.reshape(-1) for x in state0[2:]]).contiguous()
    root0 = torch.cat([state0[0][0], state0[1][0]]).contiguous()
    return (packed, cond_l0, cond_g0, gaze[0, 1:].contiguous(), p0, h, root0, pipe.dt)


def check_kernels(torch, card):
    """Phase 1: the decoder kernel against its plain version at v1 width."""
    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR

    pipe = GesturePipeline(WORK / "models", WORK / "processed", device="cuda")
    report, fp32_rows = {}, None
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                        ("int8", torch.int8)):
        args = rollout_inputs(torch, pipe, dtype, "clip_10s")
        T1 = args[1].shape[0]
        # one step from the same state
        step = (args[0], args[1][:1], args[2][:1], args[3][:1]) + args[4:]
        err_step = (DR.rollout_b1(*step) - DR.rollout_b1_plain(*step)).abs().max().item()
        # the whole rollout
        rows, plain = DR.rollout_b1(*args), DR.rollout_b1_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(rows).all():
            fail(f"{name}: kernel rollout is not finite")
        diff = (rows - plain).abs()
        mae, err_max = diff.mean().item(), diff.max().item()
        plan = DR.card_plan(args[0])
        print(f"decoder_rollout[{name}] plan: {plan.blocks} blocks of {DR.THREADS} threads, "
              f"{plan.smem_bytes} B shared memory each, resident share {plan.resident_share:.4f}, "
              f"{plan.streamed_bytes / 1e6:.3f} MB staged from L2 a step, staging area up to "
              f"{plan.staging_bytes} B")
        print(f"decoder_rollout[{name}] one step max|err| "
              f"{err_step:.3e} (tol {STEP_TOL[name]:g}); {T1}-step rollout MAE {mae:.3e} "
              f"(tol {ROLLOUT_MAE:g}), max|err| {err_max:.3e}")
        if err_step > STEP_TOL[name]:
            fail(f"{name}: one-step kernel/plain error {err_step} > {STEP_TOL[name]}")
        if mae >= ROLLOUT_MAE:
            fail(f"{name}: rollout kernel/plain MAE {mae} >= {ROLLOUT_MAE}")
        if name == "float32":
            fp32_rows = rows
        elif name == "int8":
            d = (rows - fp32_rows).abs()
            rel = d.max().item() / max(1.0, fp32_rows.abs().max().item())
            print(f"decoder_rollout[int8] against the fp32 kernel, {T1} steps: trajectory MAE "
                  f"{d.mean().item():.3e}, max err / max(1, max|fp32|) {rel:.3e} "
                  f"(bound {INT8_VS_FP32:g})")
            if not rel < INT8_VS_FP32:
                fail(f"int8 against fp32 weights: {rel} >= {INT8_VS_FP32}")
        # times: plain, kernel, kernel, plain after a warm-up of each
        DR.rollout_b1(*args)
        DR.rollout_b1_plain(*args)
        p1 = event_ms(torch, lambda: DR.rollout_b1_plain(*args), 2)
        k1 = event_ms(torch, lambda: DR.rollout_b1(*args), 10)
        k2 = event_ms(torch, lambda: DR.rollout_b1(*args), 10)
        p2 = event_ms(torch, lambda: DR.rollout_b1_plain(*args), 2)
        packed = args[0]
        weights = packed.wx.numel() + packed.wh.numel()
        nbytes = (weights * packed.wx.element_size() + sum(
            t.numel() * t.element_size() for t in args[1:7] if torch.is_tensor(t))
            + rows.numel() * 4)
        bound_ms, bound_by = bound(nbytes, 2 * weights * T1, name)
        report[name] = dict(err_step=err_step, mae=mae, err_max=err_max, ms=min(k1, k2),
                            plain_ms=min(p1, p2), T1=T1, bound_ms=bound_ms, bound_by=bound_by,
                            resident_share=plan.resident_share)
        print(f"time decoder_rollout[{name}] {T1} steps: kernel {k1:.3f} / {k2:.3f} ms "
              f"({min(k1, k2) / T1 * 1e3:.2f} us a step), plain {p1:.3f} / {p2:.3f} ms, bound "
              f"{bound_ms * 1e3:.1f} us ({bound_by}: {nbytes / 1e6:.1f} MB, "
              f"{2 * weights * T1 / 1e9:.2f} G{'OP' if name == 'int8' else 'FLOP'}), {card}")
    del pipe
    return report


def barrier_floor(torch, card, steps):
    """Phase 1a: steps x 4 grid barriers and nothing else on the rollout's
    grid, with the kernel's barrier and with cooperative groups' grid sync;
    in turns, after a warm-up of each."""
    from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR

    times = {}
    for barrier in ("grid", "cg", "grid", "cg"):
        DR.barrier_floor(steps, barrier)
        ms = event_ms(torch, lambda: DR.barrier_floor(steps, barrier), 5)
        times[barrier] = min(times.get(barrier, ms), ms)
    floor = {k: {"ms": v, "us_per_step": v / steps * 1e3, "us_per_barrier": v / (4 * steps) * 1e3}
             for k, v in times.items()}
    print(f"time barrier floor, {steps} steps x 4 barriers: kernel's grid barrier "
          f"{times['grid']:.3f} ms ({floor['grid']['us_per_step']:.2f} us a step), "
          f"cg grid sync {times['cg']:.3f} ms ({floor['cg']['us_per_step']:.2f} us a step), {card}")
    return floor


def check_gru_cell(torch, card):
    """Phase 1b: the GRU-cell kernel against its plain version."""
    from zeggs_tpu_torch.ops.kernels import gru_cell as GC

    report = {"err": 0.0}
    for B, in_dim, H in GRU_SHAPES:
        torch.manual_seed(SEED + B)
        cell = torch.nn.GRUCell(in_dim, H, device="cuda")
        p = GC.pack_gru(cell)
        rng = np.random.default_rng(SEED + B)
        x = torch.as_tensor(rng.normal(size=(B, in_dim)).astype(np.float32), device="cuda")
        h = torch.as_tensor(rng.normal(size=(B, H)).astype(np.float32), device="cuda")
        out = GC.fused_gru_cell(p, x, h)
        torch.cuda.synchronize()
        err = (out - GC.gru_cell_plain(p, x, h)).abs().max().item()
        print(f"gru_cell B={B} in={in_dim} H={H}: max|err| {err:.3e} (tol {GRU_TOL:g})")
        if not (torch.isfinite(out).all() and err <= GRU_TOL):
            fail(f"gru_cell at {(B, in_dim, H)}: kernel/plain error {err} > {GRU_TOL}")
        report["err"] = max(report["err"], err)
        if in_dim == H == 1024 and B in GRU_TIMED:
            def kernel():
                return GC.fused_gru_cell(p, x, h)

            def plain():
                return GC.gru_cell_plain(p, x, h)

            def library():  # the yardstick; the port never calls it
                return torch.gru_cell(x, h, cell.weight_ih, cell.weight_hh, cell.bias_ih,
                                      cell.bias_hh)

            lib_err = (library() - out).abs().max().item()
            kernel(), plain()
            # device time from CUDA graphs, in turns; eager launches one after
            # another measure the host's launch rate instead
            p1, k1, l1, l2, k2, p2 = (graph_ms(torch, f)
                                      for f in (plain, kernel, library, library, kernel, plain))
            ek, el = event_ms(torch, kernel, 200), event_ms(torch, library, 200)
            nbytes = 4 * (p.weight_ih.numel() + p.weight_hh.numel() + 4 * H + x.numel()
                          + 2 * h.numel())
            bound_ms, bound_by = bound(nbytes, 2 * B * 3 * H * (in_dim + H), "float32")
            ms = min(k1, k2)
            print(f"time gru_cell B={B} one step (device, CUDA graph): kernel {k1 * 1e3:.2f} / "
                  f"{k2 * 1e3:.2f} us, plain {p1 * 1e3:.2f} / {p2 * 1e3:.2f} us, torch.gru_cell "
                  f"{l1 * 1e3:.2f} / {l2 * 1e3:.2f} us (max|diff| {lib_err:.2e}), bound "
                  f"{bound_ms * 1e3:.2f} us ({bound_by}), {bound_ms / ms:.1%} of the bound; eager "
                  f"launches: kernel {ek * 1e3:.2f} us, torch.gru_cell {el * 1e3:.2f} us, {card}")
            report[B] = dict(ms=ms, plain_ms=min(p1, p2), library_ms=min(l1, l2),
                             bound_ms=bound_ms, bound_by=bound_by, eager_ms=ek,
                             eager_library_ms=el)
    return report


def read_wav(name):
    from zeggs_tpu_torch.io import wav

    _, audio = wav.read_wavfile(WORK / f"{name}.wav", rescale=True, desired_fs=16000,
                                out_type="float32")
    return np.asarray(audio, np.float32)


def check_mel(torch, card):
    """Phase 1c: the mel kernel against its plain version: the three clips
    through `mel_spectrogram_tts`, the streaming session's windows cut from
    the 10 s clip's padded signal, an input shorter than n_fft and a zero
    window, as `finish()` can hand it."""
    from zeggs_tpu_torch.config import load_pipeline_conf
    from zeggs_tpu_torch.ops import mel as M
    from zeggs_tpu_torch.ops.kernels import mel as MK

    cfg, _ = load_pipeline_conf(ROOT / "configs" / "data_pipeline_conf_v1.json")
    consts = MK.mel_consts(cfg, torch.device("cuda"))
    report = {"err": 0.0}

    def check(label, kernel, plain):
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        print(f"mel_spectrogram {label}: {tuple(out.shape)} max|err| {err:.3e} (tol {MEL_TOL:g})")
        if not (torch.isfinite(out).all() and out.shape == ref.shape and err <= MEL_TOL):
            fail(f"mel_spectrogram {label}: kernel/plain error {err} > {MEL_TOL}")
        report["err"] = max(report["err"], err)

    clips = {name: torch.as_tensor(read_wav(name), device="cuda") for name in CLIPS}
    clips["short"] = clips["clip_04s"][:500]
    for name, x in clips.items():
        check(f"{name} ({x.shape[0]} samples)", lambda: M.mel_spectrogram_tts(x, cfg),
              lambda: M.mel_spectrogram_tts(x, cfg, fused=False))
    padded = torch.nn.functional.pad(clips["clip_10s"][None, None], (400, 400),
                                     mode="reflect")[0, 0]
    for nf in MEL_WINDOWS:
        for label, x in (("window", padded), ("zero window", torch.zeros_like(padded))):
            w = x[: (nf - 1) * cfg.hop_length + cfg.filter_length].contiguous()
            check(f"{label} of {nf} frames", lambda: MK.mel_frames(w, nf, cfg),
                  lambda: MK.mel_frames_plain(w, nf, consts))

    # times: the 10 s clip's core and a 32-frame window
    clip_frames = M.num_frames(padded.shape[0], cfg.filter_length, cfg.hop_length)
    for label, nf in (("10 s clip", clip_frames), ("window", 32)):
        w = padded[: (nf - 1) * cfg.hop_length + cfg.filter_length].contiguous()

        def kernel():
            return MK.mel_frames(w, nf, cfg)

        def plain():
            return MK.mel_frames_plain(w, nf, consts)

        kernel(), plain()
        p1, k1, k2, p2 = (event_ms(torch, f, 100) for f in (plain, kernel, kernel, plain))
        print(f"time mel_spectrogram {label}, {nf} frames: kernel {k1 * 1e3:.2f} / "
              f"{k2 * 1e3:.2f} us, plain {p1 * 1e3:.2f} / {p2 * 1e3:.2f} us, {card}")
        # the least work: a real FFT of each frame (5/2 n log2 n FLOPs) and the
        # mel product over the filters' nonzero bins; the samples read once
        # and the (frames, n_mels) rows written once
        n_fft = cfg.filter_length
        flops = nf * (2.5 * n_fft * np.log2(n_fft) + 2 * int((consts.basis != 0).sum().item()))
        bound_ms, bound_by = bound(4 * (w.numel() + nf * cfg.n_mel_channels), flops, "float32")
        print(f"bound mel_spectrogram {label}: {bound_ms * 1e3:.3f} us ({bound_by}), {card}")
        report[nf] = dict(ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=bound_ms,
                          bound_by=bound_by)
    report["clip_frames"] = clip_frames
    return report


def reset_counts():
    from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR
    from zeggs_tpu_torch.ops.kernels import gru_cell as GC
    from zeggs_tpu_torch.ops.kernels import mel as MK

    DR.launches = GC.launches = MK.launches = 0


def read_counts():
    """Launches since `reset_counts`. Each path runs one weight dtype, so
    the decoder count is that dtype's."""
    from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR
    from zeggs_tpu_torch.ops.kernels import gru_cell as GC
    from zeggs_tpu_torch.ops.kernels import mel as MK

    return {"decoder_rollout": DR.launches, "gru_cell": GC.launches,
            "mel_spectrogram": MK.launches}


def check_bvhs(results, label):
    from zeggs_tpu_torch.io import bvh

    for clip, seconds in CLIPS.items():
        anim = bvh.load(results / f"{clip}.bvh")
        frames = anim["rotations"].shape[0]
        finite = bool(np.isfinite(anim["rotations"]).all() and np.isfinite(anim["positions"]).all())
        print(f"{label} {clip}: {frames} frames, frametime {anim['frametime']:.6f}, "
              f"finite {finite}")
        if not (frames == round(60 * seconds) and abs(anim["frametime"] - DT) < 1e-6 and finite):
            fail(f"{label} {clip}: bad BVH ({frames} frames, expected {round(60 * seconds)})")


def run_cli_path(torch, results, label, flags, expected):
    """Phase 2: the generate CLI over the three clips on the card, every
    launch count reset just before and read just after."""
    from zeggs_tpu_torch.cli import generate as cli

    argv = ["-o", str(WORK / "options.json"), "-c", str(WORK / "requests.csv"),
            "-p", str(results), "--device", "cuda", *flags]
    reset_counts()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"{label}: {len(CLIPS)} requests, launches {counts}, CLI wall {wall:.3f} s "
          "(pipeline load included)")
    for name, n in counts.items():
        if n != expected.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected {expected.get(name, 0)}")
    check_bvhs(results, label)
    return counts


def bvh_mae(torch, a_path, b_path):
    from zeggs_tpu_torch.io import bvh

    a, b = bvh.load(a_path), bvh.load(b_path)
    if a["rotations"].shape != b["rotations"].shape:
        fail(f"{a_path.name}: {a['rotations'].shape} frames against {b['rotations'].shape}")
    return max(np.abs(a["positions"] - b["positions"]).mean(),
               np.abs(a["rotations"] - b["rotations"]).mean())


def batched_vs_single(torch, results):
    """The `-b` requests through generate_batch against single requests,
    both at fp32 rollout weights and the same seeds."""
    from zeggs_tpu_torch.cli import generate as cli
    from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
    from zeggs_tpu_torch.infer.batch import generate_batch

    pipe = GesturePipeline(WORK / "models", WORK / "processed", device="cuda",
                           rollout_weights="float32")
    with open(WORK / "requests.csv", newline="") as f:
        reqs = cli._requests(list(csv.DictReader(f)), "example")
    generate_batch(pipe, reqs, results / "batch_fp32")
    worst = 0.0
    for r in reqs:
        generate_gesture(r.audio, r.styles, None, None, results / "single_fp32",
                         file_name=r.file_name, temperature=r.temperature, seed=r.seed,
                         pipeline=pipe)
        mae = bvh_mae(torch, results / "batch_fp32" / f"{r.file_name}.bvh",
                      results / "single_fp32" / f"{r.file_name}.bvh")
        print(f"batched against single (fp32 weights) {r.file_name}: BVH MAE {mae:.3e} "
              f"(tol {ROLLOUT_MAE:g})")
        worst = max(worst, mae)
    if not worst < ROLLOUT_MAE:
        fail(f"batched against single requests: BVH MAE {worst} >= {ROLLOUT_MAE}")


def time_batch(torch, card, results):
    """64 copies of the 10 s clip through generate_batch: one chunk of B=64
    at T_pad 1024, bf16 pipeline; the second of two runs."""
    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer.batch import Request, generate_batch

    pipe = GesturePipeline(WORK / "models", WORK / "processed", device="cuda")
    reqs = [Request(audio=WORK / "clip_10s.wav", styles=[(WORK / "style.bvh", None)],
                    file_name=f"copy_{i}", seed=SEED + i) for i in range(BATCH_COPIES)]
    frames = BATCH_COPIES * round(60 * CLIPS["clip_10s"])
    for rep in range(2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = generate_batch(pipe, reqs, results / "batch64")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    if len(written) != BATCH_COPIES or counts["gru_cell"] != 1023:
        fail(f"batch of {BATCH_COPIES}: wrote {len(written)}, launches {counts}")
    print(f"time batch of {BATCH_COPIES} x 10 s clips (one B=64 chunk, T_pad 1024, "
          f"{frames} frames): {wall:.3f} s wall, {frames / wall:.1f} frames/s, {card}")


def time_requests(torch, card, results):
    """Per-request wall time on a loaded pipeline, and peak device memory."""
    from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture

    pipe = GesturePipeline(WORK / "models", WORK / "processed", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    for rep in range(2):
        for clip, seconds in CLIPS.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate_gesture(WORK / f"{clip}.wav", [(WORK / "style.bvh", None)], None, None,
                             results / "timed", file_name=clip, seed=SEED, pipeline=pipe)
            torch.cuda.synchronize()
            if rep == 1:
                print(f"time request {clip} ({seconds:g} s audio, bf16 kernel): "
                      f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall, {card}")
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"peak device memory over the requests: {peak:.1f} MiB, {card}")


def card_vs_cpu(torch):
    """Phase 3: one request on the card and on the CPU at temperature 0."""
    from zeggs_tpu_torch.infer import GesturePipeline

    def trajectories(pipe):
        with torch.inference_mode():
            feats, n = pipe.audio_to_features(WORK / "clip_04s.wav")
            speech = pipe.encode_speech(feats)
            vec, f0 = pipe.style_example_from_bvh(WORK / "style.bvh")
            style = pipe.encode_style(vec, 0.0)[0][:, None].expand(-1, n, -1).contiguous()
            out = pipe.rollout(f0, f0.gaze_pos[0].expand(n, 3)[None], speech, style)
        return [o.float().cpu() for o in out]

    cpu = trajectories(GesturePipeline(WORK / "models", WORK / "processed", device="cpu"))
    maes = {}
    for weights in ("float32", "bfloat16"):
        card = trajectories(GesturePipeline(WORK / "models", WORK / "processed", device="cuda",
                                            rollout_weights=weights))
        maes[weights] = max((a - b).abs().mean().item() for a, b in zip(card, cpu))
        print(f"card ({weights} rollout weights) vs CPU, 4 s request: trajectory MAE "
              f"{maes[weights]:.3e}")
    if not maes["float32"] < CARD_VS_CPU_MAE:
        fail(f"card vs CPU MAE {maes['float32']} >= {CARD_VS_CPU_MAE}")


def bvh_maes(a_path, b_path):
    """(position MAE, Euler angle MAE) between two BVHs of one length."""
    from zeggs_tpu_torch.io import bvh

    a, b = bvh.load(a_path), bvh.load(b_path)
    if a["rotations"].shape != b["rotations"].shape:
        fail(f"{b_path.name}: {b['rotations'].shape} frames against {a['rotations'].shape}")
    if not (np.isfinite(b["positions"]).all() and np.isfinite(b["rotations"]).all()):
        fail(f"{b_path.name}: not finite")
    return (float(np.abs(a["positions"] - b["positions"]).mean()),
            float(np.abs(a["rotations"] - b["rotations"]).mean()))


def run_session(torch, pipe, audio):
    """One session over the clip in 0.5 s pushes, quantum 16 -> (session,
    times)."""
    t_start = time.perf_counter()
    sess = pipe.streaming_session([(WORK / "style.bvh", None)], seed=SEED, quantum=16)
    t0 = time.perf_counter()
    ttff, lats = None, []
    for o in range(0, len(audio), PUSH_SAMPLES):
        t1 = time.perf_counter()
        new = sess.push(audio[o : o + PUSH_SAMPLES])
        lats.append(time.perf_counter() - t1)
        if ttff is None and new["root_pos"].shape[0]:
            ttff = time.perf_counter() - t0
    t1 = time.perf_counter()
    sess.finish()
    torch.cuda.synchronize()
    end = time.perf_counter()
    return sess, dict(start_s=t0 - t_start, ttff_s=ttff, push_p50_s=float(np.percentile(lats, 50)),
                      push_p99_s=float(np.percentile(lats, 99)), finish_s=end - t1,
                      total_s=end - t_start, rtf=(len(audio) / 16000) / (end - t0))


def streaming(torch, card, results):
    """Phase 5: a streaming session on the card against the offline request.
    Loudness normalisation is global and a stream takes a fixed gain, so
    both run without it, as tests/test_streaming.py does."""
    from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture

    audio = read_wav("clip_10s")
    out = results / "stream"
    report = {}
    for weights in ("float32", "bfloat16"):
        pipe = GesturePipeline(WORK / "models", WORK / "processed", device="cuda",
                               rollout_weights=weights)
        pipe.mel_cfg = dataclasses.replace(pipe.mel_cfg, normalize_loudness=False)
        reset_counts()
        generate_gesture(WORK / "clip_10s.wav", [(WORK / "style.bvh", None)], None, None, out,
                         file_name=f"offline_{weights}", seed=SEED, pipeline=pipe)
        torch.cuda.synchronize()
        offline_counts = read_counts()
        reset_counts()
        sess, times = run_session(torch, pipe, audio)
        counts = read_counts()
        pos, rot = bvh_maes(out / f"offline_{weights}.bvh",
                            sess.write_bvh(out, f"stream_{weights}"))
        print(f"streaming session ({weights} pipeline), 10 s clip in 0.5 s pushes, quantum 16: "
              f"{sess.frames_emitted} frames, {sess.decoder_steps} decoder steps, launches "
              f"{counts}; against offline ({weights} decoder kernel): position MAE {pos:.3e}, "
              f"rotation MAE {rot:.3e} deg")
        if sess.frames_emitted != round(60 * CLIPS["clip_10s"]):
            fail(f"streaming: {sess.frames_emitted} frames")
        if not (counts["mel_spectrogram"] > 0 and counts["gru_cell"] == sess.decoder_steps
                and counts["decoder_rollout"] == 0):
            fail(f"streaming launches {counts} for {sess.decoder_steps} decoder steps")
        if weights == "bfloat16":
            continue  # reported, not bounded: the bf16 kernel rounds every activation
        if not (pos < STREAM_POS_MAE and rot < STREAM_ROT_MAE):
            fail(f"streaming against offline at fp32 weights: MAE {pos}, {rot}")
        report.update(counts=counts, offline_counts=offline_counts)
        for label in ("cold", "warm"):
            if label == "warm":
                _, times = run_session(torch, pipe, audio)
            print(f"time streaming {label} session: start {times['start_s'] * 1e3:.1f} ms, "
                  f"time to first frame {times['ttff_s'] * 1e3:.1f} ms, push p50 "
                  f"{times['push_p50_s'] * 1e3:.1f} ms, p99 {times['push_p99_s'] * 1e3:.1f} ms, "
                  f"finish {times['finish_s'] * 1e3:.1f} ms, total {times['total_s']:.3f} s, "
                  f"realtime factor {times['rtf']:.2f}, {card}")
    return report


def post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        fail(f"{path}: HTTP {e.code} {e.read()[:500]!r}")


def decode_frames(f):
    return {k: np.frombuffer(base64.b64decode(v["b64"]), np.float32).reshape(v["shape"])
            for k, v in f["data"].items()}


def serve(torch, card):
    """Phase 6: the daemon on 127.0.0.1 with the default (bf16) pipeline."""
    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.serve import GestureServer

    pipe = GesturePipeline(WORK / "models", WORK / "processed", device="cuda")
    srv = GestureServer(pipe, max_batch=8, max_wait_ms=500)
    port = srv.start()
    try:
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                                   timeout=60).read())
        print(f"serve /healthz: {health}")
        if health.get("platform") != "cuda" or health.get("device") != torch.cuda.get_device_name(0):
            fail(f"/healthz does not report the card: {health}")
        style = base64.b64encode((WORK / "style.bvh").read_bytes()).decode()
        reset_counts()
        replies = [None] * 4

        def request(i):
            clip = list(CLIPS)[i % len(CLIPS)]
            t0 = time.perf_counter()
            replies[i] = post(port, "/synthesize", {
                "audio_wav_b64": base64.b64encode((WORK / f"{clip}.wav").read_bytes()).decode(),
                "styles": [{"bvh_b64": style}], "seed": SEED + i})
            replies[i]["client_ms"] = (time.perf_counter() - t0) * 1e3

        threads = [threading.Thread(target=request, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if any(r is None for r in replies):
            fail("serve: a /synthesize request failed")
        sizes = [r["batch_size"] for r in replies]
        synth_counts = read_counts()
        lat = [r["client_ms"] for r in replies]
        print(f"serve: 4 concurrent /synthesize, batch sizes {sizes}, launches {synth_counts}; "
              f"time request p50 {np.percentile(lat, 50):.1f} ms (client), server p50 "
              f"{srv.stats.snapshot()['latency_ms_p50']} ms, {card}")
        if max(sizes) < 2:
            fail(f"serve: concurrent requests did not coalesce: {sizes}")

        audio = read_wav("clip_04s")
        parts = np.array_split(audio, 5)
        reset_counts()
        start = post(port, "/stream/start", {"styles": [{"bvh_b64": style}], "seed": SEED})
        chunks = [decode_frames(start["frames"])]
        for part in parts:
            r = post(port, "/stream/push", {"session_id": start["session_id"],
                                            "audio_f32_b64": base64.b64encode(
                                                part.astype("<f4").tobytes()).decode()})
            chunks.append(decode_frames(r["frames"]))
        fin = post(port, "/stream/finish", {"session_id": start["session_id"]})
        chunks.append(decode_frames(fin["frames"]))
        stream_counts = read_counts()
        sess = pipe.streaming_session([(WORK / "style.bvh", None)], seed=SEED, quantum=16)
        direct = [sess._collect(0)] + [sess.push(p) for p in parts] + [sess.finish()]
        err = max(np.abs(np.concatenate([c[k] for c in chunks])
                         - np.concatenate([d[k] for d in direct])).max() for k in direct[0])
        print(f"serve: stream over HTTP, {fin['total_frames']} frames, launches {stream_counts}; "
              f"against the in-process session max|diff| {err:.3e} (tol {HTTP_TOL:g})")
        if fin["total_frames"] != round(60 * CLIPS["clip_04s"]) or not err <= HTTP_TOL:
            fail(f"serve stream: {fin['total_frames']} frames, max|diff| {err}")
        for name, counts in (("/synthesize", synth_counts), ("/stream", stream_counts)):
            if counts["mel_spectrogram"] == 0:
                fail(f"serve {name}: the mel kernel was not launched: {counts}")
        return {"synthesize": synth_counts, "stream": stream_counts}
    finally:
        srv.stop()


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device available")
    from zeggs_tpu_torch.device import require_device
    from zeggs_tpu_torch.ops.kernels import build

    require_device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name}")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"built {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())

    results = write_fixture(torch)
    with torch.inference_mode():
        report = check_kernels(torch, card)
        floor = barrier_floor(torch, card, report["bfloat16"]["T1"])
        gru = check_gru_cell(torch, card)
        mel = check_mel(torch, card)
    n = len(CLIPS)
    csv_counts = run_cli_path(torch, results, "main path (CSV, bf16)", [],
                              {"decoder_rollout": n, "mel_spectrogram": n})
    batch_counts = run_cli_path(torch, results / "batched", "batched path (-b, bf16)", ["-b"],
                                {"decoder_rollout": 1, "gru_cell": 1023, "mel_spectrogram": n})
    batched_vs_single(torch, results)
    int8_counts = run_cli_path(torch, results / "int8", "int8 path (--int8)", ["--int8"],
                               {"decoder_rollout": n, "mel_spectrogram": n})
    time_requests(torch, card, results)
    time_batch(torch, card, results)
    card_vs_cpu(torch)
    stream = streaming(torch, card, results)
    served = serve(torch, card)
    if "jax" in sys.modules:
        fail("jax was imported")

    def decoder_entry(weights, launches):
        r = report[weights]
        return {"name": f"decoder_rollout[{weights}]", "route": "cuda",
                "source": "zeggs_tpu_torch/csrc/decoder_rollout.cu",
                "replaces": "zeggs_tpu/ops/pallas/decoder_kernel.py:568",
                "launches": launches, "max_abs_err": r["err_step"], "tol": STEP_TOL[weights],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "resident_share": r["resident_share"], "steps": r["T1"]}

    print(json.dumps({"launches": {"csv": csv_counts, "batched": batch_counts,
                                   "int8": int8_counts, "streaming": stream["counts"],
                                   "serve": served}}))
    print(json.dumps({"barrier_floor": {"steps": report["bfloat16"]["T1"], **floor}}))
    print(json.dumps({"kernels": [
        decoder_entry("float32", stream["offline_counts"]["decoder_rollout"]),
        decoder_entry("bfloat16", csv_counts["decoder_rollout"]),
        decoder_entry("int8", int8_counts["decoder_rollout"]),
        {"name": "gru_cell", "route": "cuda", "source": "zeggs_tpu_torch/csrc/gru_cell.cu",
         "replaces": "zeggs_tpu/ops/pallas/gru_kernel.py:46",
         "launches": batch_counts["gru_cell"], "max_abs_err": gru["err"], "tol": GRU_TOL,
         **{k: gru[64][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "batch": 64, "by_batch": {str(B): gru[B] for B in GRU_TIMED}},
        {"name": "mel_spectrogram", "route": "cuda",
         "source": "zeggs_tpu_torch/csrc/mel_spectrogram.cu",
         "replaces": "zeggs_tpu/ops/pallas/mel_kernel.py:58",
         "launches": csv_counts["mel_spectrogram"], "max_abs_err": mel["err"], "tol": MEL_TOL,
         **{k: mel[mel["clip_frames"]][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
