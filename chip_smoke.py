#!/usr/bin/env python3
"""Kernel checks of the PyTorch/CUDA port (zeggs_tpu_torch) on one NVIDIA
card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ (one nvcc per source, all at once) and
fails on a register spill in nvcc's report; writes a full-width v1 fixture
made from a seed (75-joint skeleton, random PyTorch-default weights,
statistics, a style BVH and three WAVs of 4, 10 and 12 s) under
build/chip_smoke/; then checks each kernel against its plain PyTorch
version at the main paths' shapes: the decoder rollout (one step and a
600-frame rollout, fp32, bf16 and int8 weights; int8 also against the fp32
kernel; with each plan's resident share), the GRU cell (B=1, 2, 3, 64 and
65 at 1024/1024 and the JAX tests' shapes), the mel spectrogram (at n_fft
800, 1024, 802 and 8192, the last through the global-workspace variant:
the three clips, the streaming windows of 1 to 512 frames, an input
shorter than n_fft and zero windows; timed at 1, 32 and the 10 s clip's
frames, and the variant forced at n_fft 800), the training rollout's
six kernels (csrc/decoder_train.cu, forward and backward, with the pose
kernels' first- and last-frame forms, at the v1 train cell's B=32, H=1024,
pose 1134/1131) and the inference step's four (csrc/decoder_step.cu, bit
for bit, at B=1, 16 and 2048, H=1024, 75 joints; then a whole step of each
decoder cell at B=16 with them and with their plain versions). It times
each against its plain version and its bound (bytes over 3.35 TB/s or
operations over the operands' peak), the mel
kernel at each launch shape, the GRU cell at B=1, 2 and 64 also against
torch.gru_cell (CUDA graphs, TF32 off), and the decoder's barrier floor:
599 x 4 grid barriers and nothing else, with the kernel's own barrier and
with cooperative groups' grid sync.

It prints the times, each beside the card's name and power limit, then a
JSON line of the checks' launches of each kernel (every kernel must have
launched), one of the seconds each part took, one of the barrier floor,
one of the kernels (each one's error and tolerance, its time, its plain
version's time and its bound: the table of PERF.md section 6) and, last,
{"ok": true, "device": {...}}.

The port's paths end to end on the card are checked by the ``cuda`` tests:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Any failure ends the run with a nonzero exit and without the last line.
It exits nonzero at once when no CUDA device is available.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
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
# int8 against fp32 weights: the bound of the JAX package's int8 tests,
# max error / max(1, max|fp32|)
INT8_VS_FP32 = 3e-2
# the GRU cell against its plain version (tests/test_pallas_kernels.py)
GRU_TOL = 2e-5
GRU_SHAPES = [(64, 1024, 1024), (2, 1024, 1024), (8, 384, 256), (16, 2304, 512),
              (1, 1024, 1024), (3, 1024, 1024), (65, 1024, 1024)]
GRU_TIMED = (1, 2, 64)  # batch sizes timed at in = H = 1024
# the training rollout's kernels (csrc/decoder_train.cu) against their
# plain versions at the v1 train cell's shapes (B=32, H=1024, 75 joints:
# pose 1134 in, 1131 out): max error over max(1, max|plain|) of each
# output (tests/test_torch_decoder_bptt.py's bound); the forward kernels
# round each operation as PyTorch's operators do, so they must equal their
# plain versions bit for bit
DT_TOL = 1e-5
DT_SHAPE = (32, 1024, 75)  # B, H, joints
# one frame of the train rollout: the forward's 4 launches and the
# backward's 4 (`ops/kernels/decoder_train.py`)
DT_FRAME = ("pose_fwd", "elu_fwd", "gru_fwd_l0", "gru_fwd_l1", "gru_bwd_l1", "gru_bwd_l0",
            "elu_bwd", "pose_bwd")
# the inference step's kernels (csrc/decoder_step.cu) against their plain
# versions, the step's own PyTorch expressions, at the offline cells' B=16
# (also B=1 and the core bench's 2048), H=1024, 75 joints: they round as
# those do, so every output must be equal bit for bit
DS_SHAPE = (16, 1024, 75)  # B, H, joints
DS_BATCHES = (1, 16, 2048)
# a step's launches: `normal` 4, FiLM 5 (the second ELU its layer2's)
DS_STEP = {"normal": ("pose_in", "elu", "gru_gates", "pose_out"),
           "film": ("pose_in", "elu_film", "gru_gates", "elu_layer2", "pose_out")}
# the mel spectrogram against its plain version (tests/test_pallas_kernels.py)
MEL_TOL = 2e-4
MEL_WINDOWS = (1, 2, 3, 8, 32, 33, 128, 512)
# n_fft of the checks: the v1 config's 800 (4 4 2 5 5), 1024 (radix 4 only),
# 802 (2 x 401, a generic stage) and 8192, whose frame pair does not fit a
# block's shared memory (the global-workspace variant); the kernels line
# reports 800
MEL_N_FFTS = (800, 1024, 802, 8192)
MEL_TIMED = (1, 32)  # frames timed besides the 10 s clip's (800 at n_fft 800)
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
    """The v1 model at full width with random weights from SEED, its data
    directory, a style BVH and the WAVs of CLIPS, under WORK."""
    from zeggs_tpu_torch.config import Options
    from zeggs_tpu_torch.io import bvh, checkpoint, wav, weights
    from zeggs_tpu_torch.models.decoder import Decoder
    from zeggs_tpu_torch.models.speech_encoder import SpeechEncoder
    from zeggs_tpu_torch.models.style_encoder import StyleEncoder

    if WORK.exists():
        shutil.rmtree(WORK)
    data, models = WORK / "processed", WORK / "models"
    for d in (data, models):
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

    bvh.save(WORK / "style.bvh", motion(rng, names, parents, 300))
    for clip, seconds in CLIPS.items():
        wav.write_wavefile(WORK / f"{clip}.wav", speech_like(rng, seconds), 16000)


# ---------------------------------------------------------------------------
# kernel checks
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
    `ops` operations of `kind` (`zeggs_tpu_torch/device.py`'s peaks)."""
    from zeggs_tpu_torch.device import HBM_BYTES_PER_S, PEAK_OPS

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


def decoder_train_cases(torch, B, H, J):
    """{case: (op, args, indices of the written args, floats the kernel
    touches)} of `ops/kernels/decoder_train.py`'s step ops at one frame,
    on strided (B, 3, ...) frame views as the Function passes them; random
    inputs from SEED. The floats touched: each input the kernel reads and
    each output it writes, once (the pose backward reads 6 floats of the
    last frame's output a row)."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    D = 6 + 15 * J
    Din = D + 3

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def frame(n, scale=1.0):
        return r(B, 3, n, scale=scale)[:, 1]

    def quats():
        q = r(B, 4)
        return q / q.norm(dim=-1, keepdim=True)

    def empty(*shape):
        return torch.full(shape, float("nan"), device="cuda")

    mean_in, std_in = r(Din, scale=0.1), r(Din).abs() + 0.5
    mean_out, std_out = r(D, scale=0.1), r(D).abs() * 0.2 + 0.05
    mean_out[3:6] = 0.0
    out = r(B, D)
    out[0, 3:6] = 0.0  # no root rotation in row 0: the exp map's small-angle branch
    p_prev = frame(D)
    p_prev[0, 3:6] = 0.0
    gates = torch.cat([torch.rand(B, 3 * H, generator=g, device="cuda"), r(B, H)], dim=1)
    gates[:, 2 * H : 3 * H] = gates[:, 2 * H : 3 * H] * 2 - 1
    a4 = r(B, 4 * H)

    def traj():  # a frame's p, root_pos, root_rot views of (B, 3, ...) buffers
        return (empty(B, 3, D)[:, 1], empty(B, 3, 3)[:, 1], empty(B, 3, 4)[:, 1])

    return {
        "pose_fwd": ("pose_fwd", (out, mean_out, std_out, None, r(B, 3), quats(), *traj(),
                                  frame(3, 5.0), mean_in, std_in, empty(B, Din), DT),
                     (6, 7, 8, 12), 2 * B * D + B * Din + 2 * D + 2 * Din + 17 * B),
        "pose_fwd_first": ("pose_fwd", (None, mean_out, std_out, r(B, D), r(B, 3), quats(),
                                        None, None, None, frame(3, 5.0), mean_in, std_in,
                                        empty(B, Din), DT),
                           (12,), B * D + B * Din + 2 * Din + 10 * B),
        "pose_fwd_last": ("pose_fwd", (r(B, D), mean_out, std_out, None, r(B, 3), quats(),
                                       *traj(), None, mean_in, std_in, None, DT),
                          (6, 7, 8), 2 * B * D + 2 * D + 14 * B),
        "elu_fwd": ("elu_fwd", (frame(H), a4[:, :H], empty(B, H), empty(B, H)), (2, 3),
                    4 * B * H),
        "gru_fwd_l0": ("gru_fwd", (frame(3 * H), r(B, 3 * H), a4[:, H:], r(B, 3 * H),
                                   r(B, 2 * H)[:, :H], empty(B, H), empty(B, 4 * H)),
                       (5, 6), 18 * B * H),
        "gru_fwd_l1": ("gru_fwd", (r(B, 3 * H), None, None, r(B, 3 * H), r(B, H), empty(B, H),
                                   empty(B, 4 * H)),
                       (5, 6), 12 * B * H),
        "gru_bwd_l1": ("gru_bwd", (r(B, H), gates, r(B, H), empty(B, 3 * H), empty(B, 3 * H)),
                       (0, 3, 4), 13 * B * H),
        "gru_bwd_l0": ("gru_bwd", (r(B, H), gates, r(B, H), empty(B, 4 * H)[:, H:],
                                   empty(B, 3 * H)),
                       (0, 3, 4), 13 * B * H),
        "elu_bwd": ("elu_bwd", (r(B, H), r(B, H, scale=3.0), empty(B, 4 * H)[:, :H]), (2,),
                    3 * B * H),
        "pose_bwd": ("pose_bwd", (r(B, Din), std_in, frame(3, 5.0), r(B, 3), quats(), empty(B, 3),
                                  frame(D), frame(3), frame(4), p_prev, quats(), std_out,
                                  empty(B, D), r(B, 3), r(B, 4), None, DT),
                     (5, 12, 13, 14), B * Din + Din + 2 * B * D + D + 44 * B),
        "pose_bwd_last": ("pose_bwd", (None, std_in, None, r(B, 3), quats(), None, frame(D),
                                       frame(3), frame(4), frame(D), quats(), std_out,
                                       empty(B, D), r(B, 3), r(B, 4), None, DT),
                          (12, 13, 14), 2 * B * D + D + 31 * B),
        "pose_bwd_first": ("pose_bwd", (r(B, Din), std_in, frame(3, 5.0), r(B, 3), quats(),
                                        empty(B, 3), None, None, None, None, None, std_out, None,
                                        r(B, 3), r(B, 4), empty(B, D), DT),
                           (5, 13, 14, 15), B * Din + Din + B * D + 27 * B),
    }


def check_decoder_train(torch, card):
    """Phase 1d: each kernel of the training rollout (forward and backward,
    and the first and last frame's forms of the pose kernels) against its
    plain version on the same inputs at the v1 train cell's shapes (the
    forward's bit for bit); then
    each one's device time (CUDA graphs, kernel and plain in turns)
    against its bound (the bytes it touches over the HBM bandwidth)."""
    from zeggs_tpu_torch.ops.kernels import build
    from zeggs_tpu_torch.ops.kernels import decoder_train as DT_K

    B, H, J = DT_SHAPE
    report = {"err": 0.0}
    launches = build.launches()["decoder_train"]
    cases = decoder_train_cases(torch, B, H, J)
    for name, (op, args, written, floats) in cases.items():
        plain = [a.clone() if i in written else a for i, a in enumerate(args)]
        getattr(DT_K.PlainOps, op)(*plain)
        getattr(DT_K.CudaOps, op)(*args)
        torch.cuda.synchronize()
        err = max((args[i] - plain[i]).abs().max().item() / max(1.0, plain[i].abs().max().item())
                  for i in written)
        unequal = sum(int((args[i] != plain[i]).sum()) for i in written)
        finite = all(bool(torch.isfinite(args[i]).all()) for i in written)
        print(f"decoder_train {name} (B={B}, H={H}, pose {6 + 15 * J + 3}/{6 + 15 * J}): max "
              f"err / max(1, max|plain|) {err:.3e} (tol {DT_TOL:g}), {unequal} elements unequal")
        if not (finite and err <= DT_TOL) or (op.endswith("_fwd") and unequal):
            fail(f"decoder_train {name}: kernel/plain error {err} (tol {DT_TOL}), {unequal} "
                 f"elements unequal, finite {finite}")
        report["err"] = max(report["err"], err)

        def kernel():
            getattr(DT_K.CudaOps, op)(*args)

        def plain_op():
            getattr(DT_K.PlainOps, op)(*plain)

        p1, k1, k2, p2 = (graph_ms(torch, f) for f in (plain_op, kernel, kernel, plain_op))
        bound_ms, bound_by = bound(4 * floats, 0, "float32")
        ms = min(k1, k2)
        print(f"time decoder_train {name} (device, CUDA graph): kernel {k1 * 1e3:.2f} / "
              f"{k2 * 1e3:.2f} us, plain {p1 * 1e3:.2f} / {p2 * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.3f} us ({bound_by}: {4 * floats / 1e6:.3f} MB), "
              f"{bound_ms / ms:.1%} of the bound, {card}")
        report[name] = dict(ms=ms, plain_ms=min(p1, p2), bound_ms=bound_ms, bound_by=bound_by,
                            max_abs_err=err, unequal=unequal)
    # each check launched once and each timing once before its capture (a
    # captured launch counts only when replayed, and graph_ms does not count)
    launched = build.launches()["decoder_train"] - launches
    if launched != 3 * len(cases):
        fail(f"decoder_train: {launched} launches, expected {3 * len(cases)}")
    frame = {k: sum(report[c][k] for c in DT_FRAME) for k in ("ms", "plain_ms", "bound_ms")}
    print(f"time decoder_train one frame's {len(DT_FRAME)} launches (device, CUDA graphs): "
          f"kernels {frame['ms'] * 1e3:.2f} us, plain {frame['plain_ms'] * 1e3:.2f} us, bound "
          f"{frame['bound_ms'] * 1e3:.3f} us, {card}")
    report["frame"] = frame
    return report


def decoder_step_cases(torch, B, H, J):
    """{case: (op, args, floats the kernel touches)} of
    `ops/kernels/decoder_step.py`'s kernels at one step, on the views the
    step passes them (the local state as views of the last step's output,
    columns of a program's 16-step conditioning); random inputs from SEED.
    The floats touched: each input read and each output written, once."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    D = 6 + 15 * J
    Din = D + 3

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def col(n, scale=1.0):  # a column of a (B, 16, n) tensor
        return r(B, 16, n, scale=scale)[:, 3]

    q = r(B, 4)
    rp, rr = r(B, 3), q / q.norm(dim=-1, keepdim=True)
    p = r(B, D)
    o = 6
    local = (p[:, 0:3], p[:, 3:6], p[:, o : o + 3 * J].reshape(B, J, 3),
             p[:, o + 3 * J : o + 9 * J].reshape(B, J, 2, 3),
             p[:, o + 9 * J : o + 12 * J].reshape(B, J, 3),
             p[:, o + 12 * J : o + 15 * J].reshape(B, J, 3))
    mean_in, std_in = r(Din, scale=0.1), r(Din).abs() + 0.5
    mean_out, std_out = r(D, scale=0.1), r(D).abs() * 0.2 + 0.05
    out = r(B, D)
    out[0, 3:6] = -mean_out[3:6] / std_out[3:6]  # row 0: the exp map's small-angle branch
    gammas, betas = col(2 * H, 0.5) + 1.0, col(2 * H, 0.5)
    return {
        "pose_in": ("pose_in", (rp, rr, *local, col(3, 5.0), mean_in, std_in),
                    B * D + 10 * B + 2 * Din + B * Din),
        "elu": ("elu", (col(H), r(B, H)), 3 * B * H),
        "elu_film": ("elu", (col(H), r(B, H), gammas[:, :H], betas[:, :H]), 5 * B * H),
        "elu_layer2": ("elu", (r(B, H), None, gammas[:, H:], betas[:, H:]), 4 * B * H),
        "gru_gates": ("gru_gates", (col(3 * H), r(B, 3 * H), r(B, 3 * H), r(B, 3 * H),
                                    r(B, 2 * H)[:, :H]), 14 * B * H),
        "pose_out": ("pose_out", (out, rp, rr, J, DT, mean_out, std_out),
                     2 * B * D + 2 * D + 14 * B),
    }


def step_case(torch, rnn_cond, B, H, J):
    """A decoder of the cell at v2's widths (speech 64, 19 labels) from
    SEED and one step of it at B rows: (step, its arguments)."""
    from zeggs_tpu_torch.infer.programs import _STATS
    from zeggs_tpu_torch.models import decoder as D

    pose_in, pose_out = 6 + 15 * J + 3, 6 + 15 * J
    torch.manual_seed(SEED)
    dec = D.Decoder(pose_in, pose_out, 64, 19, H, 2, rnn_cond).cuda().eval()
    dec.requires_grad_(False)
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def r(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    stats = dict(zip(_STATS, (r(pose_in, scale=0.1), r(pose_in).abs() + 0.5,
                              r(pose_out, scale=0.1), r(pose_out).abs() * 0.2 + 0.05)))
    q = r(B, 4)
    state0 = (r(B, 3), q / q.norm(dim=-1, keepdim=True), r(B, 3, scale=0.1), r(B, 3, scale=0.1),
              r(B, J, 3), r(B, J, 2, 3), r(B, J, 3, scale=0.1), r(B, J, 3, scale=0.1))
    gaze, speech, style = r(B, 2, 3, scale=100.0), r(B, 2, 64), r(B, 2, 19)
    carry = D.init_carry(dec, *state0, gaze[:, 0], style[:, 0], *list(stats.values())[:2])
    conditioning, step, _ = D.chunk_step(dec, *stats.values(), DT, J)
    cols = tuple(c[:, 0] for c in conditioning(speech[:, 1:], style[:, 1:]))
    return step, (gaze[:, 1], *cols, carry[0][0], carry[0][1].contiguous(), *carry[1:])


def check_decoder_step(torch, card):
    """Phase 1e: each kernel of the inference step against its plain version
    on the same inputs at B of DS_BATCHES (bit for bit), and each one's
    device time (CUDA graphs, kernel and plain in turns) against its bound
    (the bytes it touches over the HBM bandwidth); then a whole step of
    each cell at B=16 with its kernels and with their plain versions (the
    step before the kernels), equal bit for bit, and both times."""
    from zeggs_tpu_torch.ops.kernels import build
    from zeggs_tpu_torch.ops.kernels import decoder_step as DS_K

    _, H, J = DS_SHAPE
    report = {"by_batch": {}}
    launches = build.launches()["decoder_step"]
    n_cases = 0
    for B in DS_BATCHES:
        by_kernel = report["by_batch"][B] = {}
        for name, (op, args, floats) in decoder_step_cases(torch, B, H, J).items():
            n_cases += 1
            got = getattr(DS_K.CudaOps, op)(*args)
            want = getattr(DS_K.PlainOps, op)(*args)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            torch.cuda.synchronize()
            unequal = sum(int((a != b).sum()) for a, b in zip(got, want))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            print(f"decoder_step {name} (B={B}, H={H}, pose {6 + 15 * J + 3}/{6 + 15 * J}): "
                  f"{unequal} elements unequal")
            if unequal or not finite:
                fail(f"decoder_step {name} at B={B}: {unequal} elements unequal to the plain "
                     f"version, finite {finite}")

            def kernel():
                getattr(DS_K.CudaOps, op)(*args)

            def plain_op():
                getattr(DS_K.PlainOps, op)(*args)

            p1, k1, k2, p2 = (graph_ms(torch, f) for f in (plain_op, kernel, kernel, plain_op))
            bound_ms, bound_by = bound(4 * floats, 0, "float32")
            ms = min(k1, k2)
            print(f"time decoder_step {name} B={B} (device, CUDA graph): kernel {k1 * 1e3:.2f} / "
                  f"{k2 * 1e3:.2f} us, plain {p1 * 1e3:.2f} / {p2 * 1e3:.2f} us, bound "
                  f"{bound_ms * 1e3:.3f} us ({bound_by}: {4 * floats / 1e6:.3f} MB), "
                  f"{bound_ms / ms:.1%} of the bound, {card}")
            by_kernel[name] = dict(ms=ms, plain_ms=min(p1, p2), bound_ms=bound_ms,
                                   bound_by=bound_by, unequal=unequal)
    # each check launched once and each timing once before its capture
    launched = build.launches()["decoder_step"] - launches
    if launched != 3 * n_cases:
        fail(f"decoder_step: {launched} launches, expected {3 * n_cases}")
    B = DS_SHAPE[0]
    report["step"] = {}
    ops = DS_K.step_ops

    def plain_ops(fn):  # fn() with the step's plain versions in its kernels' place
        DS_K.step_ops = lambda state, plain: DS_K.PlainOps
        try:
            return fn()
        finally:
            DS_K.step_ops = ops

    for cell, kernels in DS_STEP.items():
        step, args = step_case(torch, cell, B, H, J)
        got, want = step(*args), plain_ops(lambda: step(*args))
        torch.cuda.synchronize()
        p1 = plain_ops(lambda: graph_ms(torch, lambda: step(*args)))
        k1, k2 = graph_ms(torch, lambda: step(*args)), graph_ms(torch, lambda: step(*args))
        p2 = plain_ops(lambda: graph_ms(torch, lambda: step(*args)))
        unequal = sum(int((a != b).sum()) for a, b in zip(got, want))
        if unequal:
            fail(f"decoder_step: a {cell} step with the kernels has {unequal} elements unequal "
                 f"to the plain step")
        kernel_sum = {k: sum(report["by_batch"][B][c][k] for c in kernels)
                      for k in ("ms", "plain_ms", "bound_ms")}
        print(f"time decoder_step a whole {cell} step B={B} (device, CUDA graph): with the "
              f"{len(kernels)} kernels {k1 * 1e3:.2f} / {k2 * 1e3:.2f} us, with their plain "
              f"versions {p1 * 1e3:.2f} / {p2 * 1e3:.2f} us; the kernels alone "
              f"{kernel_sum['ms'] * 1e3:.2f} us (plain {kernel_sum['plain_ms'] * 1e3:.2f}, bound "
              f"{kernel_sum['bound_ms'] * 1e3:.3f}), {card}")
        report["step"][cell] = dict(ms=min(k1, k2), plain_ms=min(p1, p2), kernels=kernel_sum)
    report["frame"] = report["step"]["normal"]["kernels"]
    return report


def read_wav(name):
    from zeggs_tpu_torch.io import wav

    _, audio = wav.read_wavfile(WORK / f"{name}.wav", rescale=True, desired_fs=16000,
                                out_type="float32")
    return np.asarray(audio, np.float32)


def check_mel(torch, card):
    """Phase 1c: the mel kernel against its plain version at n_fft 800 (the
    v1 config), 1024 and 802 (hop n_fft / 4): the three clips through
    `mel_spectrogram_tts`, the streaming session's windows cut from the 10 s
    clip's padded signal, an input shorter than n_fft and zero windows, as
    `finish()` can hand them; then its times at 1, 32 and 800 frames."""
    from zeggs_tpu_torch.config import load_pipeline_conf
    from zeggs_tpu_torch.ops import mel as M
    from zeggs_tpu_torch.ops.kernels import mel as MK

    v1, _ = load_pipeline_conf(ROOT / "configs" / "data_pipeline_conf_v1.json")
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n_fft in MEL_N_FFTS:
        cfg = dataclasses.replace(v1, filter_length=n_fft, hop_length=n_fft // 4)
        consts = MK.mel_consts(cfg, torch.device("cuda"))
        padded = torch.nn.functional.pad(clips["clip_10s"][None, None], (n_fft // 2,) * 2,
                                         mode="reflect")[0, 0]
        print(f"mel_spectrogram n_fft {n_fft}: stages {consts.plan.radices}, hop {cfg.hop_length}")
        for name, x in clips.items():
            check(f"n_fft {n_fft} {name} ({x.shape[0]} samples)",
                  lambda: M.mel_spectrogram_tts(x, cfg),
                  lambda: M.mel_spectrogram_tts(x, cfg, fused=False))
        for nf in MEL_WINDOWS:
            if (nf - 1) * cfg.hop_length + n_fft > padded.shape[0]:
                continue  # longer than the clip at this hop
            for label, x in (("window", padded), ("zero window", torch.zeros_like(padded))):
                w = x[: (nf - 1) * cfg.hop_length + n_fft].contiguous()
                check(f"n_fft {n_fft} {label} of {nf} frames", lambda: MK.mel_frames(w, nf, cfg),
                      lambda: MK.mel_frames_plain(w, nf, consts))

        # times: one frame, a 32-frame window and the 10 s clip's frames (800
        # at n_fft 800); device times from CUDA graphs (eager launches
        # measure the host's launch rate once the kernel is shorter); at
        # n_fft 800 also the eager times, the bound, and each launch shape at
        # the clip's frames
        clip_frames = M.num_frames(padded.shape[0], n_fft, cfg.hop_length)
        for nf in (*MEL_TIMED, clip_frames):
            w = padded[: (nf - 1) * cfg.hop_length + n_fft].contiguous()

            def kernel():
                return MK.mel_frames(w, nf, cfg)

            def plain():
                return MK.mel_frames_plain(w, nf, consts)

            kernel(), plain()
            p1, k1, k2, p2 = (graph_ms(torch, f) for f in (plain, kernel, kernel, plain))
            groups, blocks = MK.launch_shape(nf, sms)
            ms = min(k1, k2)
            variant = ("global-workspace variant" if MK._workspace_bytes(
                0, nf, consts.twiddles.shape[0], consts.filters.shape[1], n_fft,
                consts.n_mels, False) else f"{blocks} blocks of {groups} frame pairs")
            line = (f"time mel_spectrogram n_fft {n_fft}, {nf} frames (device, CUDA graph; "
                    f"{variant}): kernel {k1 * 1e3:.2f} / {k2 * 1e3:.2f} us, plain "
                    f"{p1 * 1e3:.2f} / {p2 * 1e3:.2f} us")
            if n_fft != v1.filter_length:
                print(f"{line}, {card}")
                report[f"n_fft_{n_fft}_{nf}"] = dict(ms=ms, plain_ms=min(p1, p2), variant=variant)
                continue
            ek, ep = event_ms(torch, kernel, 100), event_ms(torch, plain, 100)
            # the least work: a real FFT of each frame (5/2 n log2 n FLOPs) and
            # the mel product over the filters' nonzero bins; the samples read
            # once and the (frames, n_mels) rows written once
            flops = nf * (2.5 * n_fft * np.log2(n_fft) + 2 * int((consts.basis != 0).sum().item()))
            bound_ms, bound_by = bound(4 * (w.numel() + nf * cfg.n_mel_channels), flops, "float32")
            print(f"{line}, bound {bound_ms * 1e3:.3f} us ({bound_by}), {bound_ms / ms:.1%} of the "
                  f"bound; eager launches: kernel {ek * 1e3:.2f} us, plain {ep * 1e3:.2f} us, {card}")
            report[nf] = dict(ms=ms, plain_ms=min(p1, p2), bound_ms=bound_ms, bound_by=bound_by,
                              eager_ms=ek, eager_plain_ms=ep, groups=groups, blocks=blocks)
            if nf == clip_frames:
                shapes = {g: min(graph_ms(torch, lambda: MK._launch(w, nf, consts, g))
                                 for _ in range(2))
                          for g in range(1, MK.MAX_GROUPS + 1)}
                print(f"time mel_spectrogram n_fft {n_fft}, {nf} frames by frame pairs a block "
                      "(device, CUDA graph): " + ", ".join(
                          f"{g}: {t * 1e3:.2f} us" for g, t in shapes.items()) + f", {card}")
                report["by_groups"] = {str(g): t for g, t in shapes.items()}
                report["clip_frames"] = clip_frames
                # the global-workspace variant, forced, on the same frames
                check(f"n_fft {n_fft} {nf} frames, global-workspace variant forced",
                      lambda: MK._launch(w, nf, consts, 1, force_global=True), plain)
                g = min(graph_ms(torch, lambda: MK._launch(w, nf, consts, 1, force_global=True))
                        for _ in range(2))
                print(f"time mel_spectrogram n_fft {n_fft}, {nf} frames, global-workspace "
                      f"variant forced (device, CUDA graph): {g * 1e3:.2f} us against "
                      f"{ms * 1e3:.2f} us in shared memory, {card}")
                report["global_variant_ms"] = g
    return report


def check_ptxas(libs):
    """Print each kernel's registers, and fail on a spill, from nvcc's
    -Xptxas -v report."""
    for lib in libs:
        log = lib.with_suffix(".log").read_text()
        print(log.strip())
        spills = [line.strip() for line in log.splitlines()
                  if re.search(r"\b[1-9]\d* bytes spill (stores|loads)", line)]
        if spills:
            fail(f"{lib.name} spills registers: {spills}")


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
    check_ptxas(libs)
    t_build = time.perf_counter()
    write_fixture(torch)
    before = build.launches()
    with torch.inference_mode():
        report = check_kernels(torch, card)
        floor = barrier_floor(torch, card, report["bfloat16"]["T1"])
        gru = check_gru_cell(torch, card)
        mel = check_mel(torch, card)
        bptt = check_decoder_train(torch, card)
        step = check_decoder_step(torch, card)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    if "jax" in sys.modules:
        fail("jax was imported")
    launched = build.launches_since(before)
    print(json.dumps({"launches": launched}))
    if not all(launched.values()):
        fail(f"the checks launched no {[k for k, n in launched.items() if not n]} kernel")
    print(json.dumps({"seconds": {"build": t_build - t0, "fixture_and_kernels": t_end - t_build,
                                  "total_s": t_end - t0}}))
    print(json.dumps({"barrier_floor": {"steps": report["bfloat16"]["T1"], **floor}}))

    def decoder_entry(weights):
        r = report[weights]
        return {"name": f"decoder_rollout[{weights}]", "route": "cuda",
                "source": "zeggs_tpu_torch/csrc/decoder_rollout.cu",
                "replaces": "zeggs_tpu/ops/pallas/decoder_kernel.py:568",
                "max_abs_err": r["err_step"], "tol": STEP_TOL[weights],
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None,
                "resident_share": r["resident_share"], "steps": r["T1"]}

    print(json.dumps({"kernels": [
        decoder_entry("float32"), decoder_entry("bfloat16"), decoder_entry("int8"),
        {"name": "gru_cell", "route": "cuda", "source": "zeggs_tpu_torch/csrc/gru_cell.cu",
         "replaces": "zeggs_tpu/ops/pallas/gru_kernel.py:46",
         "max_abs_err": gru["err"], "tol": GRU_TOL,
         **{k: gru[64][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "batch": 64, "by_batch": {str(B): gru[B] for B in GRU_TIMED}},
        {"name": "mel_spectrogram", "route": "cuda",
         "source": "zeggs_tpu_torch/csrc/mel_spectrogram.cu",
         "replaces": "zeggs_tpu/ops/pallas/mel_kernel.py:58",
         "max_abs_err": mel["err"], "tol": MEL_TOL,
         **{k: mel[mel["clip_frames"]][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "frames": mel["clip_frames"],
         "by_frames": {str(nf): mel[nf] for nf in (*MEL_TIMED, mel["clip_frames"])},
         "by_groups": mel["by_groups"], "global_variant_ms": mel["global_variant_ms"],
         "n_fft_8192": {k: v for k, v in mel.items() if str(k).startswith("n_fft_8192")}},
        {"name": "decoder_train", "route": "cuda",
         "source": "zeggs_tpu_torch/csrc/decoder_train.cu", "replaces": None,
         "max_abs_err": bptt["err"], "tol": DT_TOL,
         **{k: bptt["frame"][k] for k in ("ms", "plain_ms", "bound_ms")}, "bound_by": "bytes",
         "library_ms": None, "shape": dict(zip(("batch", "hidden", "joints"), DT_SHAPE)),
         "frame": list(DT_FRAME),
         "by_kernel": {k: v for k, v in bptt.items() if k not in ("err", "frame")}},
        {"name": "decoder_step", "route": "cuda",
         "source": "zeggs_tpu_torch/csrc/decoder_step.cu", "replaces": None,
         "max_abs_err": 0.0, "tol": 0.0,
         **{k: step["frame"][k] for k in ("ms", "plain_ms", "bound_ms")}, "bound_by": "bytes",
         "library_ms": None, "shape": dict(zip(("batch", "hidden", "joints"), DS_SHAPE)),
         "step_launches": {cell: list(k) for cell, k in DS_STEP.items()},
         "by_batch": {str(B): v for B, v in step["by_batch"].items()},
         "whole_step": step["step"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
