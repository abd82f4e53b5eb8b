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
     1024/1024 and the JAX tests' shapes) and the mel spectrogram (at
     n_fft 800, 1024, 802 and 8192, the last through the global-workspace
     variant: the three clips, the streaming windows of 1 to 512 frames, an
     input shorter than n_fft and zero windows; timed at 1, 32 and the 10 s
     clip's frames, and the variant forced at n_fft 800) and the training
     rollout's six kernels (csrc/decoder_train.cu, forward and backward,
     with the pose kernels' first- and last-frame forms, at the v1 train
     cell's B=32, H=1024, pose 1134/1131); fails on a register spill in nvcc's
     report; times each against its plain version and its bound (bytes
     over 3.35 TB/s or operations over the operands' peak), the mel kernel
     at each launch shape, the GRU cell at B=1, 2 and 64 also against
     torch.gru_cell (CUDA graphs, TF32 off), and the decoder's barrier
     floor: 599 x 4 grid barriers and nothing else, with the kernel's own
     barrier and with cooperative groups' grid sync;
  2. drives each path through the generate CLI over the three clips on the
     card, every launch count reset just before and read just after: CSV
     mode (3 bf16 decoder launches), `-b` (buckets of 512 frames: one B=1
     decoder launch and a B=2 chunk replayed from CUDA graphs, 1023
     GRU-cell launches and one eager warm-up step for each of the three
     programs captured, then batched against single requests at fp32
     weights) and `--int8` (3 int8 decoder launches); each path launches
     the mel kernel once a request;
  3. times single requests and a batch of 64 copies of the 10 s clip;
  4. compares a request on the card (fp32 rollout weights) with the same
     request on the CPU;
  5. streams the 10 s clip in 0.5 s pushes (quantum 16) through a session
     and holds its frames against the offline request (fp32 rollout
     weights; 608 decoder steps, the tail padded to the grain of 16, and
     one warm-up step for the session's program); times the first frame,
     the pushes and the realtime factor;
  6. serves the pipeline on 127.0.0.1: four concurrent /synthesize
     requests that must share a batch, a stream over HTTP against an
     in-process session, and /healthz; then the mesh phase: a mesh of two
     replicas on cuda:0 (`parallel.create_mesh`), each a worker thread and
     stream of its own and its own slot of programs, each run's programs
     captured before it by `warmup`: the 64-clip batch with one replica
     and with the mesh in turns (frames/s; 2 x 1023 GRU-cell launches from
     the workers, no decoder launch, one mel launch a request from the
     main thread), the `-b` requests at fp32 rollout weights against the
     unsharded run (each chunk padded to two rows: 2 x 511 + 2 x 1023),
     and four concurrent /synthesize to a daemon with the mesh against
     `generate_batch` without one (BVH MAE < 1e-3 both); with several
     cards, the 64-clip batch over every card (skipped on one card); then
     the programs phase: `warmup` over the fixture's plan (18 rollout
     graphs and 12 finish graphs, one a planned shape of more than one row:
     their capture times and memory, peak memory), and the `-b` requests,
     the 64-clip batch, a 10 s session and four concurrent /synthesize
     each through the CUDA graphs and through the eager step they replace,
     in turns (frames/s, rollout stage, push p50 / p99, realtime factor,
     client p50; launch counts; graphed against eager within 1e-6 BVH MAE);
     then the output_stage phase: a float32-transfer and a float16-transfer
     pipeline, each warmed first, run the 64-clip batch and a CSV of 64
     copies of each clip (three chunks of 64 at T_pad 512, 1024, 1024;
     2,557 GRU-cell launches, 192 mel launches), recording the bytes
     pulled a chunk (twice as many at float32), every float16 BVH against
     its float32 one (median Euler-angle difference < 0.05 degrees,
     positions 0.5 cm, the angle between the rotations < 0.2 degrees; the
     largest Euler-angle difference reported), the float32 CSV at pipeline
     depth 2, then 0 (wall seconds, report only; the BVHs equal), the
     float16 64-clip batch under torch.profiler (after the chunk's last
     graph launch nothing but `aten::copy_` launches work), the stage's
     cost on one 64 x 1024 chunk in turns (the rollout programs alone, with
     the finish graph, with the stage eager; device time) and one daemon
     /synthesize at float16 against float32;
     and, after the last phase, a host sync injected into the step, whose
     capture must raise;
  7. writes the fixture's networks as the reference's whole-module .pt
     pickles: `cli.convert` must give back the .npz trees array for array,
     and `cli.generate` from a directory of only the .pt files must write
     the .npz directory's BVH text (1 decoder and 1 mel launch), which
     `cli.compare --json` must report as equal; Griffin-Lim (30
     iterations) on the 10 s clip's mel kernel output, card against CPU
     from one first signal, timed;
  8. trains: one small-width step's gradients on the card against the CPU
     (TF32 off); then a raw corpus of 4 clips of 20 s (75 joints, the last
     one validation) through `python -m zeggs_tpu_torch.cli.pipeline` (one
     mel launch a clip and stretch; data_info.html and two normalised BVHs
     a clip and stretch), `cli.train` at full v1 width for 6 steps, the
     trainer's program (`train/programs.py`: an eager warm-up step, then
     the captured step replayed from a CUDA graph; its capture seconds,
     kernels and pool memory), a checkpoint and sample synthesis at
     iteration 0 (rollout programs: one GRU-cell launch a decoder step and
     one a capture; a train step launches the training rollout's kernels,
     8 a frame and one more a window, and no other kernel; every parameter
     a finite nonzero gradient in the first step) and a resume for one more
     step that must restore the whole training state; then the captured
     step against the eager step on a copy of the same state, in turns on
     the same inputs (5 rounds: parameters, RAdam moments and losses after
     3 within rtol 2e-5 / atol 1e-6, a second eager copy's distance
     reported; medians), the card's busy share over 3 replays
     (torch.profiler), sample synthesis through the programs and eagerly
     in turns (BVHs within 1e-6) and the eager step's breakdown; prints the
     steps' times, launches and peak memory and the pipeline's seconds a
     clip;
  9. trains over two processes sharing the card (`cli.train` with the
     multi-process flags, gloo; this script re-run as `--ddp-worker`), v1
     width, B=32, window 64, 3 steps, on both data paths, each process
     replaying graphs A (gather, forward, backward) and B (RAdam) around
     the eager all-reduce: the parameters must equal one process's (one
     graph); rank 0's sample synthesis launches the GRU cell; then one
     NCCL process for two steps (the second captured), joined from
     torchrun's environment variables (no flags);
 10. runs the v2 model (configs/configs_v2.json: the v1 widths with label
     styles, a decoder styled by the one-hot of 19 labels, no style
     encoder): the generate CLI with `-se label` over the three clips (CSV
     at bf16 weights 3 decoder launches, `-b` one decoder launch and 1023
     GRU-cell launches, `--int8` 3 int8 decoder launches; 3 mel launches
     each), the 4 s label request on the card against the CPU, a 10 s
     session with a label style (a GRU-cell launch a decoder step), one
     daemon /synthesize with `style_label` (and an unknown label refused
     with 400); then the training corpus through `cli.pipeline` under
     data_pipeline_conf_v2.json and `cli.train` with the v2 options for 3
     steps, with sample synthesis from one-hot styles;
 11. trains at v1 width, B=32, for 2 steps under each training option
     (none, bfloat16 compute, remat, the gru style body, FiLM,
     `--host-batches`; finite losses, step times, each option's capture
     seconds, kernels and graph pool memory), then holds remat's
     gradients to the step without it (rtol 1e-5, atol 1e-6) and a
     bfloat16 step to the float32 step and, over one decoder step, to the
     CPU's bfloat16 step (4e-2 of max(1, max|g|));
 12. evaluates the training phase's checkpoint with `cli.eval_checkpoint`
     on the card and on the CPU (the reports agree within the quality
     test's tolerances, the gate verdicts are equal; the card's rollouts
     replay the rollout programs: one GRU-cell launch a decoder step of
     the validation rollouts and one a capture), on the card also through
     the eager rollout in turns (seconds; rollouts within 1e-6), and
     checks that the v2 checkpoint is refused;
 13. runs the full-recipe CLI (`cli.train_full`): its corpus (6 clips of
     8 s) through the pipeline on the card, 60 steps at v1 width in
     float32 (a checkpoint and samples every 50), first stopped by a 6 s
     `--max-hours` budget (a checkpoint, the curve marked partial), then
     resumed: the merged curve holds every logged iteration once; then
     `cli.eval_checkpoint` of the last checkpoint through the rollout
     programs;
 14. runs the port's benchmark, `python -m zeggs_tpu_torch.bench --quick`
     (core at B=64 and 5 B=1 runs, serve with 4 requests, a 5 s stream, 3
     train replays a dtype; full width) as a process group of its own
     within 240 s: its last line must come from the card, every stage
     finished (no failure, skip or watchdog cut), every `correct` true,
     and each stage's kernels launched (core: decoder and GRU cell; serve:
     the three inference kernels; streaming: GRU cell and mel; train: the
     training rollout's);
 15. runs the port's last programs at full v1 width, cut in depth
     (`programs_left`): `cli.train_curve` (40 iterations a dtype on the
     recipe's corpus) and `cli.train_anneal` (30 iterations, its corpus
     built on the card), each curve in its JAX record's schema and finite;
     `profilers.fused_b1_profile` (the rollout programs against the decoder
     kernel at bf16 and int8 on a 10 s clip), `loss_profile`,
     `grad_profile` and `train_step_profile` (every section captured as a
     CUDA graph and timed eager and graphed; the last two launch the
     training rollout's kernels), `train_roofline` at float32
     and bfloat16 against the bench's train steps, and
     `examples.quickstart`;
 16. prints times, each beside the card's name and power limit, a JSON
     line of launch counts, one of training results, one of the
     checkpoint, multi-process and Griffin-Lim phases' results, one of the
     v2, training-option and quality phases' results, one of the mesh
     phase's, one of the programs phase's, one of the output_stage and
     recipe phases', one of the bench phase's, one of the programs_left
     phase's, one of each phase's wall seconds, one of the barrier floor,
     one of kernel results and, last, {"ok": true, "device": {...}}.

Any failure ends the run with a nonzero exit and without the last line.
It exits nonzero at once when no CUDA device is available.
"""

from __future__ import annotations

import base64
import contextlib
import csv
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import signal
import socket
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
BATCH_COPIES = 64
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
# the mel spectrogram against its plain version (tests/test_pallas_kernels.py)
MEL_TOL = 2e-4
MEL_WINDOWS = (1, 2, 3, 8, 32, 33, 128, 512)
# n_fft of the checks: the v1 config's 800 (4 4 2 5 5), 1024 (radix 4 only),
# 802 (2 x 401, a generic stage) and 8192, whose frame pair does not fit a
# block's shared memory (the global-workspace variant); the kernels line
# reports 800
MEL_N_FFTS = (800, 1024, 802, 8192)
MEL_TIMED = (1, 32)  # frames timed besides the 10 s clip's (800 at n_fft 800)
# a streaming session against the offline request at fp32 rollout weights:
# BVH positions (cm) and Euler angles (degrees), tests/test_streaming.py
STREAM_POS_MAE, STREAM_ROT_MAE = 1e-4, 1e-3
PUSH_SAMPLES = 8000  # 0.5 s
# GRU-cell launches of the `-b` CLI path's chunk of two clips at T_pad 1024
# on a new pipeline: 1023 steps replayed from the 16-, 4- and 1-step
# programs (63, 3 and 3 replays) and one eager warm-up step a capture
B_CHUNK_GRU = 1023 + 3
# decoder steps of a 10 s session at quantum 16: 599 steps in chunks of
# multiples of 16, the finish tail padded to the grain
SESSION_STEPS = -(-599 // 16) * 16
# frames over HTTP against the same session run in the process
HTTP_TOL = 1e-5
# the rollout programs (CUDA graphs) against the eager step they replay, at
# fp32: BVH MAE and session frames (bitwise equal expected: the same kernels
# on the same inputs)
GRAPH_MAE = 1e-6
# training: a raw corpus of 4 clips of 20 s (the last one validation),
# the v1 widths, a handful of steps and one more after the resume
TRAIN_CLIPS, TRAIN_SECONDS, TRAIN_STEPS = 4, 20.0, 6
# the train step replayed from CUDA graphs against the eager step on a copy
# of the same state, in turns: GRAPH_ROUNDS rounds (timed; medians), the
# states compared after TRAIN_COMPARED (the multi-process bound); the card's
# busy share over BUSY_REPLAYS replays
GRAPH_ROUNDS, TRAIN_COMPARED, BUSY_REPLAYS = 5, 3, 3
TRAIN_RTOL, TRAIN_ATOL = 2e-5, 1e-6
# gradients of one small-width step on the card against the CPU, per leaf,
# relative to max(1, max|g|) (TF32 off on the card)
GRAD_TOL = 1e-4
# two processes sharing the card (gloo) against one process: v1 width,
# B=32 (16 rows a process), 3 steps, JAX's multi-host bound
# (tests/test_multihost.py); the window is cut from 256 to 64 frames and
# sample synthesis to 1 clip of at most 5 s a split (depth, for time)
DDP_BATCH, DDP_STEPS, DDP_WINDOW = 32, 3, 64
DDP_RTOL, DDP_ATOL = 2e-5, 1e-6
DDP_SAMPLES, DDP_SAMPLE_S = 1, 5
DDP_TIMEOUT_S = 600
# Griffin-Lim on the card against the CPU from the same first signal: the
# relative L2 error bound of tests/test_torch_misc.py
GL_ITERATIONS, GL_TOL = 30, 1e-4
NETWORKS = ("speech_encoder", "style_encoder", "decoder")
# the v2 model (configs/configs_v2.json): the v1 widths with label styles;
# the released dataset's 19 labels make the decoder's style input 19 wide
V2 = WORK / "v2"
V2_LABELS = ["Agreement", "Angry", "Disagreement", "Distracted", "Flirty", "Happy", "Laughing",
             "Neutral", "Old", "Oration", "Pensive", "Relaxed", "Sad", "Sarcastic", "Scared",
             "Sneaky", "Still", "Threatening", "Tired"]
V2_STYLES = ("Agreement", "Happy", "Tired")  # a label a request: the first, a middle, the last
V2_TRAIN_STEPS = 3
# training options, each a run of `cli.train` at v1 width, B=32, window 256
# on the training corpus: its options and flags; OPTION_STEPS steps, sample
# synthesis cut as in the multi-process phase (depth, for time)
TRAIN_OPTIONS = {
    "none": ({}, {}, []),  # the v1 options as they are, the others' baseline
    "bfloat16": ({"compute_dtype": "bfloat16"}, {}, []),
    "remat": ({"remat": True}, {}, []),
    "gru_style_body": ({}, {"style_encoder": {"type": "gru"}}, []),
    "film": ({}, {"decoder": {"rnn_cond": "film"}}, []),
    "host_batches": ({}, {}, ["--host-batches"]),
}
OPTION_STEPS = 2
# remat against no remat: one step's gradients on the card, per element
REMAT_RTOL, REMAT_ATOL = 1e-5, 1e-6
# bfloat16 products: the bound tests/test_torch_train_grads.py holds the
# port's bfloat16 step to against JAX's (loss rtol 1e-4, every gradient 4e-2
# of max(1, max|g|)), here for the card's bfloat16 step against the CPU's over
# one decoder step (2-frame windows, BF16_BATCH rows) and, gradients only,
# for a whole bfloat16 step (B=32, window 256) against the float32 step on
# the card
BF16_LOSS_RTOL, BF16_GRAD_TOL, BF16_BATCH = 1e-4, 4e-2, 4
# the output stage: the float16 transfer against float32: the median
# Euler-angle difference (degrees, modulo 360) and the positions (cm) within
# the bounds of tests/test_batch_infer.py's float16 test, and the angle
# between the written rotations within F16_ROTATION_DEG (float16 rounds a
# unit quaternion's components by at most ~2.4e-4, which turns its rotation
# by at most ~0.06 degrees; the root joint's BVH rotation composes three
# such quaternions; the quaternions are normalised on the host). That
# test's largest Euler-angle difference (3 degrees) is reported, not
# bounded: near gimbal lock (a middle angle near +-90 degrees) the outer
# angles of one rotation move by tens of degrees for a 0.05-degree
# rotation. A CSV of STAGE_COPIES requests of each clip: one chunk of 64 at
# T_pad 512 (4 s) and two at 1024 (10, 12 s)
F16_ANGLE_MEDIAN, F16_POS_ATOL, F16_ROTATION_DEG = 0.05, 0.5, 0.2
F16_EULER_REPORTED = 3.0
STAGE_COPIES = 64
# the output stage's cost on one 64 x 1024 chunk: rounds of the paths in turns
STAGE_TURNS = 5
# the recipe (`cli.train_full`): its corpus (6 clips of 8 s), RECIPE_STEPS
# steps at v1 width in float32, checkpoints and samples every
# RECIPE_CKPT_EVERY, the loss logged every RECIPE_LOG_EVERY; the first run
# stopped by a budget of RECIPE_BUDGET_S seconds, then resumed (depth cut
# from 200 steps, checkpoints every 100 and a 30 s budget, for the script's
# time). The budget has to fall inside the first run, after its step 1
# (the capture, ~2.5 s in): on an NVIDIA H100 80GB HBM3 at 700 W, at ~111
# ms a step, 6 s stopped it at iteration 47 and 15 s let all 60 finish
# (10.6 s)
RECIPE_STEPS, RECIPE_CKPT_EVERY, RECIPE_LOG_EVERY, RECIPE_BUDGET_S = 60, 50, 10, 6.0
# the evaluation on the card against the CPU: the tolerances of
# tests/test_torch_quality.py (rtol 1e-3 and one rounding quantum; jerk
# and variance ratios within bounds derived from the rollouts' difference)
EVAL_RTOL = 1e-3
# the bench phase: `python -m zeggs_tpu_torch.bench --quick` (a depth cut at
# full width) within BENCH_TIMEOUT_S, on a budget that leaves its orchestrator
# BENCH_MARGIN_S to print its last line (about 1.8 times the 169 s of a
# --quick run on an NVIDIA H100 80GB HBM3 at 700 W: a slower host ran its
# five stages past 210 s); the kernels each stage's path must launch
BENCH_TIMEOUT_S, BENCH_MARGIN_S = 300, 30
BENCH_STAGES = ("core", "serve", "streaming", "train", "train_bf16")
BENCH_REQUIRED = {"core": ("decoder_rollout", "gru_cell"),
                  "serve": ("decoder_rollout", "gru_cell", "mel_spectrogram"),
                  "streaming": ("gru_cell", "mel_spectrogram"),
                  "train": ("decoder_train",)}
# the programs_left phase: the recipe's curve and anneal runs, the five
# profilers and the quickstart at full v1 width, cut in depth: the curve's
# LEFT_CURVE_ITERS iterations a dtype (400 in full), the anneal's
# LEFT_ANNEAL_ITERS logged every LEFT_ANNEAL_LOG (10,000 in full) and
# LEFT_REPS timed calls a profiler section
LEFT_CURVE_ITERS, LEFT_ANNEAL_ITERS, LEFT_ANNEAL_LOG, LEFT_REPS = 40, 30, 5, 2
# the v1 decoder cell's product weights (scripts/train_roofline.py:58)
CELL_PARAMS = 18_910_208


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
    from zeggs_tpu_torch.ops.kernels import decoder_train as DT_K

    B, H, J = DT_SHAPE
    report = {"err": 0.0}
    launches = DT_K.launches
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
    if DT_K.launches - launches != 3 * len(cases):
        fail(f"decoder_train: {DT_K.launches - launches} launches, expected {3 * len(cases)}")
    frame = {k: sum(report[c][k] for c in DT_FRAME) for k in ("ms", "plain_ms", "bound_ms")}
    print(f"time decoder_train one frame's {len(DT_FRAME)} launches (device, CUDA graphs): "
          f"kernels {frame['ms'] * 1e3:.2f} us, plain {frame['plain_ms'] * 1e3:.2f} us, bound "
          f"{frame['bound_ms'] * 1e3:.3f} us, {card}")
    report["frame"] = frame
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


def kernel_modules():
    """{kernel: its wrapper module, which holds the launch counter}."""
    from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR
    from zeggs_tpu_torch.ops.kernels import decoder_train as DT_K
    from zeggs_tpu_torch.ops.kernels import gru_cell as GC
    from zeggs_tpu_torch.ops.kernels import mel as MK

    return {"decoder_rollout": DR, "decoder_train": DT_K, "gru_cell": GC,
            "mel_spectrogram": MK}


def reset_counts():
    for module in kernel_modules().values():
        module.launches = 0


def read_counts():
    """Launches since `reset_counts`. Each path runs one weight dtype, so
    the decoder count is that dtype's."""
    return {name: module.launches for name, module in kernel_modules().items()}


def launch_counts(**launched):
    """{kernel: launches} over every kernel, 0 where ``launched`` names none."""
    return {name: launched.get(name, 0) for name in kernel_modules()}


def bptt_launches(frames):
    """The training rollout's launches over a window of ``frames`` + 1
    frames whose first frame is data: 4 a frame forward and 4 backward, and
    the first frame's pose kernel in the forward."""
    return 8 * frames + 1


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


def run_cli_path(torch, results, label, flags, expected, fixture=WORK):
    """Phase 2: the generate CLI over the three clips on the card, every
    launch count reset just before and read just after; ``fixture`` holds
    the options and the requests (the v1 fixture, or the v2 one)."""
    from zeggs_tpu_torch.cli import generate as cli

    argv = ["-o", str(fixture / "options.json"), "-c", str(fixture / "requests.csv"),
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


def run_session(torch, pipe, audio, styles=None, first_pose=None):
    """One session over the clip in 0.5 s pushes, quantum 16, styled by the
    fixture's style BVH unless ``styles`` are given -> (session, times)."""
    t_start = time.perf_counter()
    sess = pipe.streaming_session(styles or [(WORK / "style.bvh", None)], first_pose=first_pose,
                                  seed=SEED, quantum=16)
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
        made = len(pipe.programs.programs())
        sess, times = run_session(torch, pipe, audio)
        counts = read_counts()
        made = len(pipe.programs.programs()) - made
        pos, rot = bvh_maes(out / f"offline_{weights}.bvh",
                            sess.write_bvh(out, f"stream_{weights}"))
        print(f"streaming session ({weights} pipeline), 10 s clip in 0.5 s pushes, quantum 16: "
              f"{sess.frames_emitted} frames, {sess.decoder_steps} decoder steps, {made} program "
              f"captured, launches {counts}; against offline ({weights} decoder kernel): position "
              f"MAE {pos:.3e}, rotation MAE {rot:.3e} deg")
        if sess.frames_emitted != round(60 * CLIPS["clip_10s"]):
            fail(f"streaming: {sess.frames_emitted} frames")
        if not (counts["mel_spectrogram"] > 0 and sess.decoder_steps == SESSION_STEPS
                and counts["gru_cell"] == sess.decoder_steps + made == SESSION_STEPS + 1
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


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def launch_sites(torch):
    """Tally each kernel's launches by (kernel, current card, "block" for a
    thread that runs a mesh's block, else "caller") while the block runs,
    through the wrappers' counters; the counts themselves are left as they
    are."""
    from zeggs_tpu_torch.infer.batch import SHARD_THREADS

    sites, lock, saved = {}, threading.Lock(), {}
    for name, mod in kernel_modules().items():
        saved[mod] = count = mod._count_launch

        def counted(*n, name=name, count=count):  # n: the launches of a graph's replay
            block = threading.current_thread().name.startswith(SHARD_THREADS)
            key = (name, f"cuda:{torch.cuda.current_device()}", "block" if block else "caller")
            with lock:
                sites[key] = sites.get(key, 0) + (n[0] if n else 1)
            count(*n)

        mod._count_launch = counted
    try:
        yield sites
    finally:
        for mod, count in saved.items():
            mod._count_launch = count


def mesh_gru_launches(frames, replicas, bucket=512, max_batch=64):
    """GRU-cell launches of `generate_batch` over a mesh for clips of these
    lengths, its programs captured: each chunk is padded to a multiple of
    the mesh and runs T_pad - 1 steps in every block."""
    buckets = {}
    for n in frames:
        t_pad = max(bucket, -(-n // bucket) * bucket)
        buckets[t_pad] = buckets.get(t_pad, 0) + 1
    return sum((t_pad - 1) * replicas
               for t_pad, count in buckets.items() for _ in range(0, count, max_batch))


def run_sharded(torch, label, run, expected, sharded=True):
    """``run()`` with every count reset just before and read just after, and
    the launch sites tallied -> (result, wall seconds, counts, sites). Fails
    unless each kernel launched as ``expected``, the mel kernel only from
    the caller's thread and the GRU cell only from the mesh's block threads
    (from the caller's where the run is not ``sharded``)."""
    reset_counts()
    torch.cuda.synchronize()
    with launch_sites(torch) as sites:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    for name, n in counts.items():
        if n != expected.get(name, 0):
            fail(f"mesh {label}: {name} launched {n} times, expected {expected.get(name, 0)}")
    threads = {"mel_spectrogram": "caller", "gru_cell": "block" if sharded else "caller"}
    if any(thread != threads.get(name, thread) for name, _, thread in sites):
        fail(f"mesh {label}: a kernel launched from the wrong thread: {sites}")
    return out, wall, counts, {"/".join(k): v for k, v in sorted(sites.items())}


def mesh_phase(torch, card, results):
    """Phase mesh: `generate_batch` and the daemon over a mesh of two
    replicas on cuda:0 (each its own worker thread and stream, over the
    pipeline's own modules, and its block's slot of the program cache) and,
    with several cards, over every card; each run's programs captured
    before it by `warmup`. The 64 x 10 s batch with one replica (no mesh)
    and with the mesh, in turns (one, mesh, mesh, one); the `-b` requests
    at fp32 rollout weights against the unsharded run (BVH MAE <
    ROLLOUT_MAE); four concurrent /synthesize against `generate_batch`
    without a mesh (the same bound)."""
    from zeggs_tpu_torch.cli import generate as cli
    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer import batch as batch_mod
    from zeggs_tpu_torch.infer.batch import Request, generate_batch, warmup
    from zeggs_tpu_torch.parallel import create_mesh, shard_rows
    from zeggs_tpu_torch.serve import GestureServer

    mesh = create_mesh(devices=["cuda:0"] * 2)
    out = results / "mesh"
    report = {"replicas": mesh.size, "card": card}
    n10 = round(60 * CLIPS["clip_10s"])
    frames = BATCH_COPIES * n10

    # 64 x 10 s: one replica and the mesh, in turns after a warm-up of each
    pipe = GesturePipeline(WORK / "models", WORK / "processed", device="cuda")
    reqs = [Request(audio=WORK / "clip_10s.wav", styles=[(WORK / "style.bvh", None)],
                    file_name=f"copy_{i}", seed=SEED + i) for i in range(BATCH_COPIES)]
    shards = [len(b) for b in shard_rows(torch.empty(BATCH_COPIES), mesh)]
    expect = {"one": {"gru_cell": 1023, "mel_spectrogram": BATCH_COPIES},
              "mesh": {"gru_cell": mesh_gru_launches([n10] * BATCH_COPIES, mesh.size),
                       "mel_spectrogram": BATCH_COPIES}}
    rates, stage = {"one": [], "mesh": []}, {}
    rollout_one, shard = pipe.rollout_batch, batch_mod._rollout_shard

    def timed_one(*args):  # the rollout stage of one replica, to the card's end
        t0 = time.perf_counter()
        result = rollout_one(*args)
        torch.cuda.synchronize()
        stage.setdefault("one", []).append(time.perf_counter() - t0)
        return result

    def timed_block(*args):  # a block's thread: rows in, rollout, host copies out
        t0 = time.perf_counter()
        result = shard(*args)
        result[1].synchronize()  # the block's copies to the host
        with lock:
            stage.setdefault("blocks", []).append(time.perf_counter() - t0)
        return result

    lock = threading.Lock()
    report["warmup"] = {"one": warmup(pipe, [n10] * BATCH_COPIES),
                        "mesh": warmup(pipe, [n10] * BATCH_COPIES, mesh=mesh)}
    pipe.rollout_batch, batch_mod._rollout_shard = timed_one, timed_block
    try:
        for label in ("one", "mesh", "mesh", "one"):
            stage.clear()
            _, wall, counts, sites = run_sharded(
                torch, f"batch of {BATCH_COPIES} ({label})",
                lambda: generate_batch(pipe, reqs, out / label,
                                       mesh=mesh if label == "mesh" else None),
                expect[label], sharded=label == "mesh")
            rates[label].append(frames / wall)
            report[f"batch64_{label}"] = {"launches": counts, "sites": sites,
                                          "rollout_stage_s": list(stage.get(
                                              "blocks" if label == "mesh" else "one", []))}
    finally:
        del pipe.rollout_batch
        batch_mod._rollout_shard = shard
    report["batch64_frames_per_s"] = rates
    report["batch64_shards"] = shards
    one_s = report["batch64_one"]["rollout_stage_s"]
    block_s = report["batch64_mesh"]["rollout_stage_s"]
    print(f"mesh: batch of {BATCH_COPIES} x 10 s clips over {mesh.size} replicas on cuda:0, "
          f"rows a shard {shards}, launches {report['batch64_mesh']['launches']}, by site "
          f"{report['batch64_mesh']['sites']}")
    print(f"time mesh batch of {BATCH_COPIES} x 10 s clips ({frames} frames): one replica "
          f"{', '.join(f'{r:.1f}' for r in rates['one'])} frames/s, {mesh.size} replicas on cuda:0 "
          f"{', '.join(f'{r:.1f}' for r in rates['mesh'])} frames/s "
          f"({max(rates['mesh']) / max(rates['one']):.3f}x best to best); rollout stage of the "
          f"last run: one replica {', '.join(f'{t:.3f}' for t in one_s)} s "
          f"({one_s[0] / 1023 * 1e3:.3f} ms a step), each block "
          f"{', '.join(f'{t:.3f}' for t in block_s)} s "
          f"({max(block_s) / 1023 * 1e3:.3f} ms a step), {card}")

    # the -b requests at fp32 rollout weights: the mesh against no mesh
    pipe32 = GesturePipeline(WORK / "models", WORK / "processed", device="cuda",
                             rollout_weights="float32")
    with open(WORK / "requests.csv", newline="") as f:
        csv_reqs = cli._requests(list(csv.DictReader(f)), "example")
    generate_batch(pipe32, csv_reqs, out / "b_plain")
    lengths = [round(60 * s) for s in CLIPS.values()]
    warmup(pipe32, lengths, mesh=mesh)
    _, _, counts, sites = run_sharded(
        torch, "-b requests", lambda: generate_batch(pipe32, csv_reqs, out / "b_mesh", mesh=mesh),
        {"gru_cell": mesh_gru_launches(lengths, mesh.size), "mel_spectrogram": len(CLIPS)})
    maes = {r.file_name: float(bvh_mae(torch, out / "b_mesh" / f"{r.file_name}.bvh",
                                       out / "b_plain" / f"{r.file_name}.bvh")) for r in csv_reqs}
    report["batched"] = {"launches": counts, "sites": sites, "bvh_mae": maes}
    print(f"mesh: -b requests (fp32 rollout weights) over {mesh.size} replicas, launches {counts}; "
          f"against no mesh BVH MAE {', '.join(f'{k} {v:.3e}' for k, v in maes.items())} "
          f"(tol {ROLLOUT_MAE:g})")
    if not max(maes.values()) < ROLLOUT_MAE:
        fail(f"mesh -b requests against no mesh: BVH MAE {maes}")

    # the daemon: four concurrent /synthesize coalesce into one batch (the
    # drain ends at the fourth) split over the mesh
    serve_reqs = [Request(audio=WORK / f"{list(CLIPS)[i % len(CLIPS)]}.wav",
                          styles=[(WORK / "style.bvh", None)], file_name=f"serve_{i}",
                          seed=SEED + i) for i in range(4)]
    warmup(pipe, [round(60 * CLIPS[Path(r.audio).stem]) for r in serve_reqs], max_batch=4,
           mesh=mesh)
    srv = GestureServer(pipe, max_batch=4, max_wait_ms=60_000, mesh=mesh)
    port = srv.start()
    try:
        style = base64.b64encode((WORK / "style.bvh").read_bytes()).decode()
        replies = [None] * 4

        def request(i):
            r = serve_reqs[i]
            t0 = time.perf_counter()
            replies[i] = post(port, "/synthesize", {
                "audio_wav_b64": base64.b64encode(r.audio.read_bytes()).decode(),
                "styles": [{"bvh_b64": style}], "seed": r.seed, "file_name": r.file_name})
            replies[i]["client_ms"] = (time.perf_counter() - t0) * 1e3

        def synthesize():
            threads = [threading.Thread(target=request, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            return threads

        threads, _, counts, sites = run_sharded(
            torch, "daemon", synthesize,
            {"gru_cell": mesh_gru_launches(
                [round(60 * CLIPS[Path(r.audio).stem]) for r in serve_reqs], mesh.size),
             "mel_spectrogram": 4})
        if any(t.is_alive() for t in threads) or any(r is None for r in replies):
            fail("mesh daemon: a /synthesize request failed")
        health = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                                   timeout=60).read())
    finally:
        srv.stop()
    generate_batch(pipe, serve_reqs, out / "serve_plain")
    maes = {}
    for r in replies:
        (out / f"{r['file_name']}.bvh").write_text(r["bvh"])
        maes[r["file_name"]] = float(bvh_mae(torch, out / f"{r['file_name']}.bvh",
                                             out / "serve_plain" / f"{r['file_name']}.bvh"))
    sizes = [r["batch_size"] for r in replies]
    lat = [r["client_ms"] for r in replies]
    report["serve"] = {"launches": counts, "sites": sites, "batch_sizes": sizes,
                       "client_ms": lat, "bvh_mae": maes}
    print(f"mesh: daemon over {mesh.size} replicas, 4 concurrent /synthesize, batch sizes {sizes}, "
          f"launches {counts}; against generate_batch without a mesh BVH MAE max "
          f"{max(maes.values()):.3e} (tol {ROLLOUT_MAE:g}); /healthz {health}; time request p50 "
          f"{np.percentile(lat, 50):.1f} ms (client), {card}")
    if sizes != [4] * 4 or not max(maes.values()) < ROLLOUT_MAE:
        fail(f"mesh daemon: batch sizes {sizes}, BVH MAE {maes}")

    # every card, where there are several
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"mesh over the real cards: skipped, {n_cards} card")
        report["cards"] = None
        return report
    cards = create_mesh()
    per_card = [len(b) for b in shard_rows(torch.empty(BATCH_COPIES), cards)]
    warmup(pipe, [n10] * BATCH_COPIES, mesh=cards)
    walls = []
    for rep in range(2):
        _, wall, counts, sites = run_sharded(
            torch, f"batch of {BATCH_COPIES} over {n_cards} cards",
            lambda: generate_batch(pipe, reqs, out / "cards", mesh=cards),
            expect["mesh"] | {"gru_cell": mesh_gru_launches([n10] * BATCH_COPIES, cards.size)})
        walls.append(wall)
    for dev in cards.devices:
        if sites.get(f"gru_cell/{dev}/block") != 1023:
            fail(f"mesh over the cards: GRU-cell launches by site {sites}")
    mae = max(float(bvh_mae(torch, out / "cards" / f"copy_{i}.bvh",
                            out / "one" / f"copy_{i}.bvh")) for i in (0, BATCH_COPIES - 1))
    report["cards"] = {"n": n_cards, "shards": per_card, "launches": counts, "sites": sites,
                       "frames_per_s": [frames / w for w in walls], "bvh_mae_vs_one": mae}
    print(f"mesh over {n_cards} cards: rows a card {per_card}, launches {counts}, by site {sites}; "
          f"first and last copy against one replica BVH MAE {mae:.3e} (tol {ROLLOUT_MAE:g}); "
          f"time {', '.join(f'{frames / w:.1f}' for w in walls)} frames/s, {card}")
    if not mae < ROLLOUT_MAE:
        fail(f"mesh over the cards against one replica: BVH MAE {mae}")
    return report


# ---------------------------------------------------------------------------
# rollout programs
# ---------------------------------------------------------------------------

class EagerPrograms:
    """The eager path that the program cache replaces, for comparison only:
    every chunk through `decoder.rollout_chunk` and `decoder.rollout`, ~295
    eager launches a decoder step (the port's batched and streamed path
    before the programs). It takes the cache's place on a pipeline
    (``pipe.programs``)."""

    def __init__(self, pipe):
        from zeggs_tpu_torch.models import decoder

        s = pipe.stats
        self.decoder, self.dec = decoder, pipe.networks["decoder"]
        self.stats = (s["anim_input_mean"], s["anim_input_std"], s["anim_output_mean"],
                      s["anim_output_std"], pipe.dt)

    def rollout_chunk(self, carry, gaze, speech, style, quantize_int8=False, slot=0):
        return self.decoder.rollout_chunk(self.dec, carry, gaze, speech, style, *self.stats,
                                          output_indices=(0, 1, 4, 5), quantize_int8=quantize_int8)

    def rollout(self, state0, gaze, speech, style, quantize_int8=False, slot=0,
                output_dtype=None):
        from zeggs_tpu_torch.infer.programs import output_stage

        out = self.decoder.rollout(self.dec, *state0, gaze, speech, style, *self.stats,
                                   output_indices=(0, 1, 4, 5), quantize_int8=quantize_int8)
        return out if output_dtype is None else output_stage(out, output_dtype)


class EagerRollouts(EagerPrograms):
    """`EagerPrograms` made as a `ProgramCache` is made, from (decoder,
    statistics, dt): it takes the cache's place in `Trainer.generate_samples`
    and `eval_checkpoint.evaluate`, which make their caches themselves
    (``train.loop.ProgramCache``, ``cli.eval_checkpoint.ProgramCache``), for
    comparison only."""

    def __init__(self, dec, stats, dt):
        from zeggs_tpu_torch.models import decoder

        self.decoder, self.dec = decoder, dec
        self.stats = (stats["anim_input_mean"], stats["anim_input_std"],
                      stats["anim_output_mean"], stats["anim_output_std"], dt)

    def programs(self):
        return []


def ladder_programs(lengths):
    """The rollout programs that `ProgramCache.rollout_chunk` captures for
    chunks of ``lengths`` decoder steps of one batch size: one a grain of
    the ladder that some chunk uses."""
    from zeggs_tpu_torch.infer.programs import GRAINS

    used = set()
    for n in lengths:
        t = 0
        while t < n:
            grain = next(g for g in GRAINS if g <= n - t)
            used.add(grain)
            t += (n - t) // grain * grain
    return len(used)


def counted_run(torch, run, label, expected):
    """``run()`` with every count reset just before and read just after ->
    (result, wall seconds, counts); fails unless each kernel launched as
    ``expected``."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if counts != {k: expected.get(k, 0) for k in counts}:
        fail(f"programs {label}: launches {counts}, expected {expected}")
    return out, wall, counts


def programs_phase(torch, card, results):
    """Phase programs: the rollout programs (CUDA graphs of the decoder
    step, `infer/programs.py`) against the eager path they replace
    (`EagerPrograms`), on one fp32-weight pipeline. `warmup` over the
    inference fixture's plan (the three clips, the 64-clip batch and every
    power-of-two drain up to 64; seconds, graphs, their memory and capture
    times, peak memory); then, each through the programs and eagerly, with
    launch counts: the `-b` requests, the 64-clip batch in turns (eager,
    graphed, graphed, eager; frames/s and the rollout stage), a 10 s
    session in turns (push p50 / p99, realtime factor) and four concurrent
    daemon /synthesize (client p50). Graphed results must equal eager ones
    within GRAPH_MAE (BVH MAE, and frames for the session)."""
    from zeggs_tpu_torch.cli import generate as cli
    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer.batch import Request, generate_batch, warmup
    from zeggs_tpu_torch.serve import GestureServer

    out = results / "programs"
    report = {"card": card}
    n10 = round(60 * CLIPS["clip_10s"])
    lengths = [round(60 * s) for s in CLIPS.values()]
    pipe = GesturePipeline(WORK / "models", WORK / "processed", device="cuda",
                           rollout_weights="float32")
    modes = {"graphed": pipe.programs, "eager": EagerPrograms(pipe)}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    warm = warmup(pipe, lengths + [n10] * BATCH_COPIES, all_pow2=True, style_jobs=[(300, 1)])
    torch.cuda.synchronize()
    warm_wall, warm_counts = time.perf_counter() - t0, read_counts()
    made = pipe.programs.programs()
    graphs = [{"B": key[2], "steps": key[3], "capture_s": p.capture_seconds,
               "bytes": p.graph_bytes, "launches": p.launches} for key, p in made]
    finishes = [{"B": key[1], "T": key[2], "capture_s": p.capture_seconds,
                 "bytes": p.graph_bytes} for key, p in pipe.programs.finishes()]
    report["warmup"] = {**warm, "wall_s": warm_wall, "launches": warm_counts,
                        "graphs": len(graphs), "graph_bytes": sum(g["bytes"] for g in graphs),
                        "capture_s": sum(g["capture_s"] for g in graphs),
                        "finish_graphs": len(finishes),
                        "finish_bytes": sum(f["bytes"] for f in finishes),
                        "finish_capture_s": sum(f["capture_s"] for f in finishes),
                        "peak_bytes": torch.cuda.max_memory_allocated(), "by_graph": graphs,
                        "by_finish": finishes}
    w = report["warmup"]
    print(f"programs: warmup of {len(warm['compiled'])} shapes {warm['compiled']}: "
          f"{warm['seconds']} s ({warm_wall:.3f} s wall), {w['graphs']} rollout graphs captured "
          f"in {w['capture_s']:.3f} s, graph memory {w['graph_bytes'] / 2**20:.1f} MiB; "
          f"{w['finish_graphs']} finish graphs in {w['finish_capture_s']:.3f} s, "
          f"{w['finish_bytes'] / 2**20:.1f} MiB; peak device memory "
          f"{w['peak_bytes'] / 2**20:.1f} MiB, launches {warm_counts}, {card}")
    for g in graphs:
        print(f"programs: graph B={g['B']} steps={g['steps']}: capture "
              f"{g['capture_s'] * 1e3:.1f} ms, {g['bytes'] / 2**20:.2f} MiB, {g['launches']} "
              "GRU-cell launches a replay")
    for f in finishes:
        print(f"programs: finish graph B={f['B']} T={f['T']}: capture "
              f"{f['capture_s'] * 1e3:.1f} ms, {f['bytes'] / 2**20:.2f} MiB")
    # every planned shape of more than one row replays programs and its finish
    # (one row takes the decoder kernel)
    batched = sorted((b, t) for t, b in warm["compiled"] if b > 1)
    if not (warm["complete"] and len(graphs) == 6 * 3
            and all(g["launches"] == g["steps"] for g in graphs)
            and sorted((f["B"], f["T"]) for f in finishes) == batched):
        fail(f"programs: warmup {warm}, graphs {graphs}, finish graphs {finishes}")

    # the -b requests: one B=1 decoder launch and the chunk of two clips
    with open(WORK / "requests.csv", newline="") as f:
        csv_reqs = cli._requests(list(csv.DictReader(f)), "example")
    b_counts = {}
    for mode in ("eager", "graphed"):
        pipe.programs = modes[mode]
        _, _, b_counts[mode] = counted_run(
            torch, lambda: generate_batch(pipe, csv_reqs, out / f"b_{mode}"), f"-b {mode}",
            {"decoder_rollout": 1, "gru_cell": 1023, "mel_spectrogram": len(CLIPS)})
    b_mae = {r.file_name: float(bvh_mae(torch, out / "b_graphed" / f"{r.file_name}.bvh",
                                        out / "b_eager" / f"{r.file_name}.bvh")) for r in csv_reqs}
    report["batched"] = {"launches": b_counts, "bvh_mae": b_mae}
    print(f"programs: -b requests graphed against eager, launches {b_counts['graphed']} / "
          f"{b_counts['eager']}, BVH MAE {b_mae} (tol {GRAPH_MAE:g})")

    # the 64-clip batch in turns, the rollout stage timed to the card's end
    reqs = [Request(audio=WORK / "clip_10s.wav", styles=[(WORK / "style.bvh", None)],
                    file_name=f"copy_{i}", seed=SEED + i) for i in range(BATCH_COPIES)]
    frames = BATCH_COPIES * n10
    rates, stages, stage = {"eager": [], "graphed": []}, {"eager": [], "graphed": []}, []
    batch_counts = {}
    rollout_batch = pipe.rollout_batch

    def timed(*args):
        t = time.perf_counter()
        result = rollout_batch(*args)
        torch.cuda.synchronize()
        stage.append(time.perf_counter() - t)
        return result

    pipe.rollout_batch = timed
    try:
        for mode in ("eager", "graphed", "graphed", "eager"):
            pipe.programs = modes[mode]
            stage.clear()
            _, wall, batch_counts[mode] = counted_run(
                torch, lambda: generate_batch(pipe, reqs, out / f"batch64_{mode}"),
                f"batch of {BATCH_COPIES} {mode}",
                {"gru_cell": 1023, "mel_spectrogram": BATCH_COPIES})
            rates[mode].append(frames / wall)
            stages[mode].append(stage[0])
    finally:
        del pipe.rollout_batch
    batch_mae = max(float(bvh_mae(torch, out / "batch64_graphed" / f"copy_{i}.bvh",
                                  out / "batch64_eager" / f"copy_{i}.bvh"))
                    for i in (0, BATCH_COPIES - 1))
    report["batch64"] = {"frames_per_s": rates, "rollout_stage_s": stages, "bvh_mae": batch_mae,
                         "launches": batch_counts}
    print(f"time programs batch of {BATCH_COPIES} x 10 s clips ({frames} frames): graphed "
          f"{', '.join(f'{r:.1f}' for r in rates['graphed'])} frames/s, eager "
          f"{', '.join(f'{r:.1f}' for r in rates['eager'])} frames/s "
          f"({max(rates['graphed']) / max(rates['eager']):.3f}x best to best); rollout stage "
          f"graphed {', '.join(f'{t:.3f}' for t in stages['graphed'])} s "
          f"({min(stages['graphed']) / 1023 * 1e3:.3f} ms a step), eager "
          f"{', '.join(f'{t:.3f}' for t in stages['eager'])} s "
          f"({min(stages['eager']) / 1023 * 1e3:.3f} ms a step); first and last copy graphed "
          f"against eager BVH MAE {batch_mae:.3e}, {card}")

    # a 10 s session in turns, after one that captures the session's program
    audio = read_wav("clip_10s")
    pipe.programs = modes["graphed"]
    run_session(torch, pipe, audio)
    sessions, times, s_counts = {}, {"eager": [], "graphed": []}, {}
    for mode in ("eager", "graphed", "graphed", "eager"):
        pipe.programs = modes[mode]
        (sess, t), _, s_counts[mode] = counted_run(
            torch, lambda: run_session(torch, pipe, audio), f"session {mode}",
            {"gru_cell": SESSION_STEPS, "mel_spectrogram": 40})
        sessions[mode] = sess
        times[mode].append(t)
    got, ref = sessions["graphed"]._collect(0), sessions["eager"]._collect(0)
    s_err = max(float(np.abs(got[k] - ref[k]).max()) for k in got)
    s_mae = float(bvh_mae(torch, sessions["graphed"].write_bvh(out, "stream_graphed"),
                          sessions["eager"].write_bvh(out, "stream_eager")))
    report["session"] = {"launches": s_counts, "max_abs_diff": s_err, "bvh_mae": s_mae,
                         "times": times}
    for mode in ("graphed", "eager"):
        def listed(key, scale=1e3, ts=times[mode]):
            return ", ".join(f"{x[key] * scale:.{1 if scale > 1 else 2}f}" for x in ts)

        print(f"time programs session {mode}, 10 s clip in 0.5 s pushes, quantum 16: push p50 "
              f"{listed('push_p50_s')} ms, p99 {listed('push_p99_s')} ms, time to first frame "
              f"{listed('ttff_s')} ms, realtime factor {listed('rtf', 1)}, {card}")
    print(f"programs: session graphed against eager, launches {s_counts['graphed']} / "
          f"{s_counts['eager']}, frames max|diff| {s_err:.3e}, BVH MAE {s_mae:.3e} "
          f"(tol {GRAPH_MAE:g})")

    # four concurrent /synthesize (4, 10, 12, 4 s): one drain of two chunks
    style = base64.b64encode((WORK / "style.bvh").read_bytes()).decode()
    serve_clips = [list(CLIPS)[i % len(CLIPS)] for i in range(4)]
    served, d_counts, client = {}, {}, {}
    for mode in ("eager", "graphed"):
        pipe.programs = modes[mode]
        srv = GestureServer(pipe, max_batch=4, max_wait_ms=60_000)
        port = srv.start()
        replies = [None] * 4

        def request(i):
            t = time.perf_counter()
            replies[i] = post(port, "/synthesize", {
                "audio_wav_b64": base64.b64encode(
                    (WORK / f"{serve_clips[i]}.wav").read_bytes()).decode(),
                "styles": [{"bvh_b64": style}], "seed": SEED + i, "file_name": f"serve_{i}"})
            replies[i]["client_ms"] = (time.perf_counter() - t) * 1e3

        def synthesize():
            threads = [threading.Thread(target=request, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            return threads

        try:
            threads, _, d_counts[mode] = counted_run(
                torch, synthesize, f"daemon {mode}",
                {"gru_cell": 511 + 1023, "mel_spectrogram": 4})
        finally:
            srv.stop()
        if any(t.is_alive() for t in threads) or any(r is None for r in replies):
            fail(f"programs daemon {mode}: a /synthesize request failed")
        if [r["batch_size"] for r in replies] != [4] * 4:
            fail(f"programs daemon {mode}: batch sizes {[r['batch_size'] for r in replies]}")
        client[mode] = [r["client_ms"] for r in replies]
        for r in replies:
            (out / f"{mode}_{r['file_name']}.bvh").write_text(r["bvh"])
        served[mode] = [r["file_name"] for r in replies]
    d_mae = max(float(bvh_mae(torch, out / f"graphed_{n}.bvh", out / f"eager_{n}.bvh"))
                for n in served["graphed"])
    pipe.programs = modes["graphed"]
    report["serve"] = {"launches": d_counts, "client_ms": client, "bvh_mae": d_mae}
    print(f"time programs daemon, 4 concurrent /synthesize in one drain: client p50 graphed "
          f"{np.percentile(client['graphed'], 50):.1f} ms, eager "
          f"{np.percentile(client['eager'], 50):.1f} ms; graphed against eager BVH MAE "
          f"{d_mae:.3e} (tol {GRAPH_MAE:g}), launches {d_counts['graphed']}, {card}")
    worst = max(max(b_mae.values()), batch_mae, s_mae, d_mae)
    if not (worst <= GRAPH_MAE and s_err <= GRAPH_MAE):
        fail(f"programs: graphed against eager BVH MAE {worst}, session frames {s_err}")
    return report


def float16_errors(torch, a_path, b_path):
    """Between two BVHs of one request: (largest and median Euler-angle
    difference in degrees, modulo 360; largest position difference in cm;
    largest angle between their rotations in degrees; Euler channels more
    than F16_EULER_REPORTED degrees apart)."""
    from zeggs_tpu_torch.io import bvh
    from zeggs_tpu_torch.ops import quat

    a, b = bvh.load(a_path), bvh.load(b_path)
    if a["rotations"].shape != b["rotations"].shape:
        fail(f"{a_path.name}: {a['rotations'].shape} against {b['rotations'].shape}")
    dr = np.abs((a["rotations"] - b["rotations"] + 180.0) % 360.0 - 180.0)
    qa, qb = (quat.from_euler(torch.deg2rad(torch.as_tensor(x["rotations"], dtype=torch.float64)),
                              x["order"]) for x in (a, b))
    cos = torch.clamp((qa * qb).sum(-1).abs(), max=1.0)
    return (float(dr.max()), float(np.median(dr)),
            float(np.abs(a["positions"] - b["positions"]).max()),
            float(torch.rad2deg(2 * torch.acos(cos)).max()), int((dr > F16_EULER_REPORTED).sum()))


def float16_within(errors):
    return (errors[1] < F16_ANGLE_MEDIAN and errors[2] <= F16_POS_ATOL
            and errors[3] < F16_ROTATION_DEG)


def launches_after_last_replay(prof):
    """From a torch.profiler run: the CUDA runtime calls on the host that
    launch work (kernels, copies, sets) after its last graph launch, each
    with the innermost aten op around it on its thread (None: launched
    outside any) -> (graph launches, [(call, op), ...]). The device's own
    records (a graph's kernels, copies and sets run after its launch call)
    are not calls."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    graphs = [e for e in events if "GraphLaunch" in e.name]
    if not graphs:
        return 0, []
    last = max(e.time_range.start for e in graphs)
    ops = [e for e in events if e.name.startswith("aten::")]
    after = []
    for e in events:
        if e.time_range.start <= last or "GraphLaunch" in e.name or not any(
                w in e.name for w in ("Launch", "Memcpy", "Memset")):
            continue
        around = [o for o in ops if o.thread == e.thread
                  and o.time_range.start <= e.time_range.start
                  and o.time_range.end >= e.time_range.end]
        op = max(around, key=lambda o: o.time_range.start).name if around else None
        after.append((e.name, op))
    return len(graphs), after


def output_stage_phase(torch, card, results):
    """Phase output_stage: batched chunks convert rotations and cast to the
    transfer dtype in a CUDA graph (each chunk's finish program, replayed
    after its rollout programs), and `generate_batch` pipelines
    its chunks (`infer.batch.PIPELINE_DEPTH`, copies to pinned memory on a
    copy stream). At float32 and at float16 transfer, each pipeline warmed
    first: the 64-clip batch (one chunk) and a CSV of 64 copies of each
    clip (three chunks: T_pad 512, 1024, 1024), with launch counts and the
    bytes pulled a chunk; every float16 BVH against its float32 one within
    the float16 bounds; the float32 CSV at depth 2, then at depth 0 (wall
    seconds, report only; the BVHs equal); the float16 64-clip batch under
    torch.profiler: after the chunk's last graph launch only copies; one
    daemon /synthesize on the float16 pipeline against float32."""
    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer import batch as batch_mod
    from zeggs_tpu_torch.infer.batch import Request, generate_batch, warmup
    from zeggs_tpu_torch.serve import GestureServer

    out = results / "output_stage"
    report = {"card": card}
    n10 = round(60 * CLIPS["clip_10s"])
    style = [(WORK / "style.bvh", None)]
    batch64 = [Request(audio=WORK / "clip_10s.wav", styles=style, file_name=f"copy_{i}",
                       seed=SEED + i) for i in range(BATCH_COPIES)]
    csv3 = [Request(audio=WORK / f"{clip}.wav", styles=style, file_name=f"{clip}_{i}",
                    seed=SEED + i) for clip in CLIPS for i in range(STAGE_COPIES)]
    lengths = [round(60 * s) for s in CLIPS.values()]
    dtypes = ("float32", "float16")
    pipes = {d: GesturePipeline(WORK / "models", WORK / "processed", device="cuda",
                                transfer_dtype=d) for d in dtypes}
    for pipe in pipes.values():
        warmup(pipe, lengths * STAGE_COPIES + [n10] * BATCH_COPIES)
    pulled, pull = [], batch_mod._pull

    def recorded_pull(out_tensors):
        pulled.append((tuple(out_tensors[0].shape[:2]), sum(o.numel() * o.element_size()
                                                             for o in out_tensors)))
        return pull(out_tensors)

    # the CSV runs' timeline: each chunk's dispatch on the host, the first write
    timeline, run_chunk = {}, batch_mod._run_chunk

    def timed_chunk(*args):
        t = time.perf_counter()
        blocks = run_chunk(*args)
        timeline.setdefault("dispatch_s", []).append(time.perf_counter() - t)
        timeline["last_inputs"] = args[4:]  # state0, gaze, audio, style
        return blocks

    def first_write(write):
        def timed(*args):
            if "t0" in timeline:  # a CSV run
                timeline.setdefault("first_write_s", time.perf_counter() - timeline["t0"])
            return write(*args)
        return timed

    # the CSV's chunks: 64 x 4 s at T_pad 512, then 64 x 10 s and 64 x 12 s at 1024
    expect = {"batch64": {"gru_cell": 1023, "mel_spectrogram": BATCH_COPIES},
              "csv3": {"gru_cell": 511 + 2 * 1023, "mel_spectrogram": STAGE_COPIES * len(CLIPS)}}
    runs = {}
    batch_mod._pull, batch_mod._run_chunk = recorded_pull, timed_chunk
    for pipe in pipes.values():
        pipe.write_result = first_write(pipe.write_result)
    try:
        # the float16 run under torch.profiler: after the chunk's last graph
        # launch, only copies (its wall is the profiled one)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        for dtype in dtypes:
            pulled.clear()
            with prof if dtype == "float16" else contextlib.nullcontext():
                _, wall, counts = counted_run(
                    torch, lambda: generate_batch(pipes[dtype], batch64, out / f"batch64_{dtype}"),
                    f"output stage batch of {BATCH_COPIES} {dtype}", expect["batch64"])
            runs[f"batch64_{dtype}"] = {"wall_s": wall, "launches": counts,
                                        "pulled": list(pulled)}
        # the CSV at depth 2 and at depth 0 in turns (float32), and at depth 2 (float16)
        for dtype, depth in (("float32", 2), ("float32", 0), ("float16", 2)):
            pulled.clear()
            timeline.clear()
            batch_mod.PIPELINE_DEPTH = depth
            timeline["t0"] = time.perf_counter()
            _, wall, counts = counted_run(
                torch, lambda: generate_batch(pipes[dtype], csv3, out / f"csv3_{dtype}_{depth}"),
                f"output stage CSV {dtype} depth {depth}", expect["csv3"])
            runs[f"csv3_{dtype}_depth{depth}"] = {
                "wall_s": wall, "launches": counts, "pulled": list(pulled),
                "dispatch_s": timeline["dispatch_s"], "first_write_s": timeline["first_write_s"]}
    finally:
        batch_mod._pull, batch_mod._run_chunk, batch_mod.PIPELINE_DEPTH = pull, run_chunk, 2
        for pipe in pipes.values():
            del pipe.write_result
    report["runs"] = runs
    by_chunk = {d: runs[f"csv3_{d}_depth2"]["pulled"] for d in dtypes}
    print(f"output stage: bytes pulled a chunk (B_pad, T_pad): float32 {by_chunk['float32']}, "
          f"float16 {by_chunk['float16']}; launches {runs['csv3_float16_depth2']['launches']}")
    if [len(v) for v in by_chunk.values()] != [3, 3] or any(
            b32 != 2 * b16 for (_, b32), (_, b16) in zip(*by_chunk.values())):
        fail(f"output stage: chunks pulled {by_chunk}")
    report["bytes_a_chunk"] = by_chunk

    # float16 against float32, every file; depth 0 against depth 2, text
    worst, errors = (0.0,) * 5, {}
    for label, reqs, dirs in (("batch64", batch64, ("batch64_float32", "batch64_float16")),
                              ("csv3", csv3, ("csv3_float32_2", "csv3_float16_2"))):
        errs = [float16_errors(torch, out / dirs[0] / f"{r.file_name}.bvh",
                               out / dirs[1] / f"{r.file_name}.bvh") for r in reqs]
        errors[label] = [max(e[i] for e in errs) for i in range(4)] + [sum(e[4] for e in errs)]
        worst = tuple(max(a, b) for a, b in zip(worst, errors[label]))
    same_depths = all(
        (out / "csv3_float32_2" / f"{r.file_name}.bvh").read_text()
        == (out / "csv3_float32_0" / f"{r.file_name}.bvh").read_text()
        for r in csv3[:: STAGE_COPIES // 4])
    report["float16_errors"] = errors
    print(f"output stage: float16 against float32 transfer, largest Euler angle / median Euler "
          f"angle (degrees) / position (cm) / rotation angle (degrees) differences, Euler "
          f"channels over {F16_EULER_REPORTED:g} degrees: batch of {BATCH_COPIES} "
          f"{errors['batch64']}, CSV of {len(csv3)} {errors['csv3']} (bounds: median "
          f"{F16_ANGLE_MEDIAN}, positions {F16_POS_ATOL}, rotation {F16_ROTATION_DEG}); depth 0 "
          f"and depth 2 write the same BVHs: {same_depths}")
    if not float16_within(worst) or not same_depths:
        fail(f"output stage: float16 against float32 {errors}, depths equal {same_depths}")
    csv_runs = ("float32_depth2", "float32_depth0", "float16_depth2")
    walls = {k: runs[f"csv3_{k}"]["wall_s"] for k in csv_runs}
    print(f"time output stage CSV of {len(csv3)} requests (3 chunks of 64), wall: float32 "
          f"pipelined (depth 2) {walls['float32_depth2']:.3f} s, then depth 0 "
          f"{walls['float32_depth0']:.3f} s, then float16 at depth 2 "
          f"{walls['float16_depth2']:.3f} s; batch of {BATCH_COPIES} "
          f"{runs['batch64_float32']['wall_s']:.3f} s float32, "
          f"{runs['batch64_float16']['wall_s']:.3f} s float16 (profiled), {card}")
    for k in csv_runs:
        r = runs[f"csv3_{k}"]
        print(f"time output stage CSV {k}: each chunk's dispatch on the host "
              f"{', '.join(f'{t:.3f}' for t in r['dispatch_s'])} s, first BVH write at "
              f"{r['first_write_s']:.3f} s of {r['wall_s']:.3f} s, {card}")
    report["csv3_wall_s"] = walls

    graphs, after = launches_after_last_replay(prof)
    eager = [a for a in after if a[1] != "aten::copy_"]
    replays = 1023 // 16 + 1023 % 16 // 4 + 1023 % 4 + 1  # the ladder's 63 + 3 + 3, the finish
    report["profile"] = {"graph_launches": graphs, "after_last_replay": len(after),
                         "eager_not_copies": eager}
    print(f"output stage: the batch of {BATCH_COPIES} at float16, profiled: {graphs} graph "
          f"launches ({replays} expected); after the last one {len(after)} launches, "
          f"{sorted(set(after), key=str)}; eager kernels other than copies: {len(eager)}")
    if graphs != replays or not after or eager:
        names = sorted({e.name for e in prof.events() if not e.name.startswith("aten::")})
        fail(f"output stage: {graphs} graph launches, after the last {after}; the profile's "
             f"other events: {names[:80]}")

    report["stage_turns"] = stage_turns(torch, card, pipes["float32"], timeline["last_inputs"])

    # the daemon at float16: one /synthesize against the float32 pipeline
    req = Request(audio=WORK / "clip_10s.wav", styles=style, file_name="daemon", seed=SEED)
    generate_batch(pipes["float32"], [req], out / "daemon_float32")
    srv = GestureServer(pipes["float16"], max_batch=4, max_wait_ms=50)
    port = srv.start()
    try:
        reset_counts()
        reply = post(port, "/synthesize", {
            "audio_wav_b64": base64.b64encode((WORK / "clip_10s.wav").read_bytes()).decode(),
            "styles": [{"bvh_b64": base64.b64encode((WORK / "style.bvh").read_bytes()).decode()}],
            "seed": SEED, "file_name": "daemon"})
        counts = read_counts()
    finally:
        srv.stop()
    (out / "daemon_float16").mkdir(parents=True, exist_ok=True)
    (out / "daemon_float16" / "daemon.bvh").write_text(reply["bvh"])
    d_err = float16_errors(torch, out / "daemon_float32" / "daemon.bvh",
                           out / "daemon_float16" / "daemon.bvh")
    report["daemon"] = {"launches": counts, "float16_errors": d_err}
    print(f"output stage: daemon /synthesize at float16 transfer, launches {counts}; against "
          f"float32 {d_err}")
    if not float16_within(d_err) or counts != launch_counts(decoder_rollout=1,
                                                            mel_spectrogram=1):
        fail(f"output stage daemon: launches {counts}, float16 against float32 {d_err}")
    return report


def stage_turns(torch, card, pipe, inputs, turns=STAGE_TURNS):
    """The output stage's cost on the last CSV chunk (64 x 1024) of the
    float32 pipeline, device time by CUDA events, in turns: the rollout
    programs alone (rot6d out), this port's path (the programs, then the
    chunk's finish graph), and the programs followed by the stage run
    eagerly (the path before the finish graph); then the finish program's
    run alone against the eager stage. Report only."""
    from zeggs_tpu_torch.infer.programs import output_stage

    state0, gaze, audio, style = inputs
    cache, f32 = pipe.programs, torch.float32
    with torch.inference_mode():
        speech, style = pipe.encode_speech_batched(audio), style.contiguous()

        def rollout(dtype=None):
            return cache.rollout(state0, gaze, speech, style, output_dtype=dtype)

        paths = {"rot6d": rollout, "finish_graph": lambda: rollout(f32),
                 "eager_stage": lambda: output_stage(rollout(), f32)}
        times = {k: [] for k in paths}
        for _ in range(turns):
            for k, fn in paths.items():
                times[k].append(event_ms(torch, fn, 1))
        out = rollout()
        finish = cache.finish(out, f32)
        alone = {"finish_graph": event_ms(torch, lambda: finish.run(out), 10),
                 "eager_stage": event_ms(torch, lambda: output_stage(out, f32), 10)}
    steps = speech.shape[1] - 1
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"time output stage in turns ({turns} each), 64 x {speech.shape[1]} chunk, device ms "
          f"(median, ms a step): rollout programs alone {med['rot6d']:.3f} "
          f"({med['rot6d'] / steps:.4f}), with the finish graph {med['finish_graph']:.3f} "
          f"({med['finish_graph'] / steps:.4f}), with the stage eager after them "
          f"{med['eager_stage']:.3f} ({med['eager_stage'] / steps:.4f}); the stage alone: "
          f"finish graph {alone['finish_graph']:.3f} ms, eager {alone['eager_stage']:.3f} ms; "
          f"{card}")
    return {"ms": times, "median_ms": med, "steps": steps, "alone_ms": alone}


def recipe_phase(torch, card):
    """Phase recipe: `python -m zeggs_tpu_torch.cli.train_full` in this
    process: `build_corpus` on the card (6 clips of 8 s, one mel launch a
    clip), then RECIPE_STEPS steps at v1 width in float32, B=32, window 256,
    the loss logged every RECIPE_LOG_EVERY and a checkpoint and samples
    every RECIPE_CKPT_EVERY: a first run stopped by a --max-hours budget of
    RECIPE_BUDGET_S seconds (a checkpoint, the curve marked partial), then
    resumed to the end; the merged curve holds every logged iteration once,
    in order, all finite; then `cli.eval_checkpoint` of the last checkpoint,
    its rollouts replaying the rollout programs (GRU-cell launches = decoder
    steps + captures)."""
    from zeggs_tpu_torch.cli import eval_checkpoint as E
    from zeggs_tpu_torch.cli import train_full as T
    from zeggs_tpu_torch.infer.programs import ProgramCache

    root = WORK / "recipe"
    shutil.rmtree(root, ignore_errors=True)
    report = {"card": card}
    reset_counts()
    t0 = time.perf_counter()
    T.build_corpus(root, device="cuda")
    torch.cuda.synchronize()
    report["corpus"] = {"s": time.perf_counter() - t0, "launches": read_counts()}
    if report["corpus"]["launches"] != launch_counts(mel_spectrogram=6):
        fail(f"recipe corpus: launches {report['corpus']['launches']}")
    argv = ["--root", str(root), "--iters", str(RECIPE_STEPS), "--dtype", "float32",
            "--log-every", str(RECIPE_LOG_EVERY), "--ckpt-every", str(RECIPE_CKPT_EVERY)]
    curve_path = root / "full_run_curve.json"
    t0 = time.perf_counter()
    first = T.main(argv + ["--max-hours", str(RECIPE_BUDGET_S / 3600)])
    cut = json.loads(curve_path.read_text())
    report["first"] = {"s": time.perf_counter() - t0, "iters_done": cut["iters_done"],
                       "completed": cut["completed"]}
    stopped = first.iteration
    del first
    gc.collect()  # the trainer's graphs and pool (`pin_sample_example_length` makes a cycle)
    if cut["completed"] or not 0 < stopped < RECIPE_STEPS or not (
            root / "models" / str(stopped)).is_dir():
        fail(f"recipe: the budget did not stop the run with a checkpoint: {report['first']}")
    t0 = time.perf_counter()
    second = T.main(argv)
    curve = json.loads(curve_path.read_text())
    report["second"] = {"s": time.perf_counter() - t0, "resumed_at": stopped,
                        "iters_done": curve["iters_done"], "completed": curve["completed"]}
    logged = curve["iters_logged"]
    merged = (logged == list(range(0, RECIPE_STEPS, RECIPE_LOG_EVERY))
              and all(len(curve[k]) == len(logged) for k in T.TERM_KEYS)
              and curve[T.TERM_KEYS[0]][: len([i for i in cut["iters_logged"] if i < stopped])]
              == [v for i, v in zip(cut["iters_logged"], cut[T.TERM_KEYS[0]]) if i < stopped])
    finite = bool(np.isfinite([curve[k] for k in T.TERM_KEYS]).all())
    losses = dict(zip(logged, curve["total_loss"]))
    step_s = report["second"]["s"] / (RECIPE_STEPS - stopped)
    print(f"recipe: corpus {report['corpus']['s']:.1f} s, launches "
          f"{report['corpus']['launches']}; first run stopped by its {RECIPE_BUDGET_S:g} s budget "
          f"at iteration {stopped} ({report['first']['s']:.1f} s), resumed to {second.iteration} "
          f"({report['second']['s']:.1f} s, {step_s:.3f} s an iteration with its start-up, "
          f"samples and checkpoints); merged curve {len(logged)} points, no duplicate or gap: "
          f"{merged}, finite {finite}; total loss "
          f"{ {i: round(losses[i], 4) for i in (logged[0], logged[len(logged) // 2], logged[-1])} }"
          f", {card}")
    if not (merged and finite and curve["completed"] and second.iteration == RECIPE_STEPS):
        fail(f"recipe: curve {logged}, finite {finite}, completed {curve['completed']}")
    report["curve"] = {"iters_logged": logged, "total_loss": curve["total_loss"],
                       "wall_s": curve["wall_s"]}
    del second
    gc.collect()

    # the gate on the last checkpoint, graphed
    lengths, rollout = [], ProgramCache.rollout

    def recorded(self, state0, gaze, speech, *args, **kw):
        lengths.append(speech.shape[1] - 1)
        return rollout(self, state0, gaze, speech, *args, **kw)

    ProgramCache.rollout = recorded
    try:
        reset_counts()
        t0 = time.perf_counter()
        code = E.main(["--root", str(root), "--iteration", str(RECIPE_STEPS)])
        torch.cuda.synchronize()
        eval_s, counts = time.perf_counter() - t0, read_counts()
    finally:
        ProgramCache.rollout = rollout
    agg = json.loads((root / f"eval_{RECIPE_STEPS}.json").read_text())
    keys = ("vel_ratio_mean", "jerk_ratio_mean", "motion_var_ratio_median")
    expected = launch_counts(gru_cell=sum(lengths) + ladder_programs(lengths))
    report["eval"] = {"exit_code": code, "s": eval_s, "launches": counts,
                      **{k: agg[k] for k in keys}}
    print(f"recipe: eval_checkpoint at iteration {RECIPE_STEPS}: exit {code} (gate "
          f"{'passed' if code == 0 else 'failed'}), {dict((k, agg[k]) for k in keys)}, "
          f"{eval_s:.3f} s, launches {counts} ({sum(lengths)} decoder steps), {card}")
    if counts != expected or code not in (0, 1):
        fail(f"recipe eval: launches {counts}, expected {expected}, exit {code}")
    return report


def bench_phase(torch, card):
    """Phase bench: `python -m zeggs_tpu_torch.bench --quick` in a process
    group of its own, killed whole past BENCH_TIMEOUT_S: its last line must
    parse, come from the card (platform "gpu"), hold every stage with no
    failure, skip or watchdog cut, every `correct` true, and each stage's
    required kernels launched."""
    torch.cuda.empty_cache()  # the stages' processes share the card with this one
    env = dict(os.environ, ZEGGS_BENCH_BUDGET_S=str(BENCH_TIMEOUT_S - BENCH_MARGIN_S))
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "zeggs_tpu_torch.bench", "--quick", "--root",
                             str(WORK / "bench")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BENCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        fail(f"the bench ran past {BENCH_TIMEOUT_S} s:\n{err[-3000:]}")
    wall = time.perf_counter() - t0
    (WORK / "bench.log").write_text(out + err)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        fail(f"the bench exited {proc.returncode}:\n{err[-3000:]}")
    last = json.loads(lines[-1])
    extra = last["extra"]
    if extra.get("platform") != "gpu":
        fail(f"the bench ran on {extra.get('platform')}, not the card")
    bad = [k for k in BENCH_STAGES if not isinstance(extra.get(k), dict)
           or {"failed", "watchdog_fired", "skipped_over_budget"} & set(extra[k])]
    if bad:
        fail(f"bench stages {bad} did not finish: {[extra.get(k) for k in bad]}")

    def corrects(node):
        if isinstance(node, dict):
            return [v for k, v in node.items() if k == "correct"] + \
                [c for v in node.values() for c in corrects(v)]
        return []

    if not corrects(extra) or not all(v is True for v in corrects(extra)):
        fail(f"a bench check failed: {extra['core'].get('checks')}")
    launches = {k: extra[k]["launches"] for k in BENCH_STAGES}
    missing = {k: [n for n in need if not launches[k][n]] for k, need in BENCH_REQUIRED.items()}
    if any(missing.values()):
        fail(f"bench stages launched none of {missing}")
    core = extra["core"]
    print(f"bench --quick: exit 0 in {wall:.1f} s; B={core['batch']} {last['value']:,.0f} "
          f"frames/s, int8 B={core['fps8_batch']} {core['fps8']:,.0f}, B=1 "
          f"{core['lat_ms']:.2f} ms (int8 {core['lat8_ms']:.2f}); serve daemon p50 "
          f"{extra['serve'].get('daemon_p50_s')} s, streaming push p50 "
          f"{extra['streaming']['push_p50_s']} s, train step {extra['train']['step_ms']} ms "
          f"(bf16 {extra['train_bf16']['step_ms']}); stage walls "
          f"{ {k: extra[k].get('stage_wall_s') for k in BENCH_STAGES} }; {card}")
    return dict(wall_s=wall, value=last["value"], launches=launches, checks=core["checks"],
                stage_wall_s={"core": extra["core_wall_s"],
                              **{k: extra[k]["stage_wall_s"] for k in BENCH_STAGES[1:]}},
                train_step_ms={"float32": extra["train"]["step_ms"],
                               "bfloat16": extra["train_bf16"]["step_ms"]})


def graphed_sections(label, out):
    """Every section a profiler timed was captured: a graph of kernels, and
    finite times eager and graphed."""
    for name, r in out.items():
        if name in ("launches", "device") or "eager" not in r:
            continue
        timings = [r["eager"], r.get("graphed") or r.get("replay")]
        if not r.get("kernels") or any(
                t is None or not np.isfinite([t["host_ms"], t["device_ms"]]).all()
                for t in timings):
            fail(f"{label} {name}: not graphed or not finite: {r}")


def programs_left(torch, card, bench):
    """Phase programs_left: the port's last programs at full v1 width, each
    through its entry point's `main`, the launch counts reset just before
    and read just after each:

      * `cli.train_curve` for LEFT_CURVE_ITERS iterations a dtype on the
        recipe phase's processed corpus (the verdict cannot be judged at
        this depth: the curve must have docs/loss_curve.json's keys and be
        finite; sample synthesis at iteration 0 launches the GRU cell);
      * `cli.train_anneal` for LEFT_ANNEAL_ITERS iterations, its own corpus
        built on the card (6 mel launches, and the training rollout's
        kernels in its float32 steps), the curve with
        docs/anneal_curve.json's keys in order, finite;
      * `profilers.fused_b1_profile` (10 s clip): the scan replays the
        rollout programs (GRU-cell launches), the kernel runs at bf16 and at
        int8 (decoder launches in each), the scan equals the eager float32
        rollout within GRAPH_MAE;
      * `profilers.loss_profile all`, `grad_profile all all3` and
        `train_step_profile all`: every section captured (kernels > 0),
        finite eager and graphed times, the training rollout's kernels
        launched by the last two (grad_profile's ``all2`` and
        ``all4`` are left to the full run: their sections take the same
        loss and step functions as ``dropgrad`` and `train_step_profile`'s
        full step, at ~20 s a section);
      * `profilers.train_roofline --json` at float32 and bfloat16, each
        against the bench phase's replayed step: the cell's weights
        CELL_PARAMS, FLOPs and the fraction of the bound;
      * `examples.quickstart`: a BVH of 240 frames and an HTTP response
        with a BVH; the decoder kernel in generate and serve, the mel kernel
        in the pipeline, generate and serve, the GRU cell in synthesis."""
    from zeggs_tpu_torch.cli import train_anneal as A
    from zeggs_tpu_torch.cli import train_curve as C
    from zeggs_tpu_torch.examples import quickstart
    from zeggs_tpu_torch.profilers import (fused_b1_profile, grad_profile, loss_profile,
                                           train_roofline, train_step_profile)

    root = WORK / "programs_left"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    report = {"card": card}

    def run(label, fn):
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        report[label] = {"s": time.perf_counter() - t0, "launches": read_counts()}
        return out

    # the recipe's short curve, on the recipe phase's corpus
    (root / "curve").mkdir()
    (root / "curve" / "processed").symlink_to(WORK / "recipe" / "processed")
    code = run("train_curve", lambda: C.main(
        ["--iters", str(LEFT_CURVE_ITERS), "--root", str(root / "curve")]))
    curve = json.loads((root / "curve" / "loss_curve.json").read_text())
    ok = (list(curve) == ["iters", *C.DTYPES]
          and all(len(curve[d]) == LEFT_CURVE_ITERS and np.isfinite(curve[d]).all()
                  for d in C.DTYPES))
    report["train_curve"].update(exit_code=code, head_tail={d: C.head_tail(curve[d])
                                                            for d in C.DTYPES})
    print(f"programs_left: train_curve --iters {LEFT_CURVE_ITERS}: exit {code}, "
          f"{report['train_curve']['s']:.1f} s, loss head/tail "
          f"{report['train_curve']['head_tail']}, launches {report['train_curve']['launches']}, "
          f"{card}")
    if not ok or code not in (0, 1) or not report["train_curve"]["launches"]["gru_cell"]:
        fail(f"programs_left train_curve: {report['train_curve']}, schema/finite {ok}")

    # the anneal run, its corpus built on the card
    code = run("train_anneal", lambda: A.main(
        ["--iters", str(LEFT_ANNEAL_ITERS), "--log-every", str(LEFT_ANNEAL_LOG),
         "--root", str(root / "anneal")]))
    curve = json.loads((root / "anneal" / "anneal_curve.json").read_text())
    record = json.loads((ROOT / "docs" / "anneal_curve.json").read_text())
    points = LEFT_ANNEAL_ITERS // LEFT_ANNEAL_LOG
    ok = (list(curve) == list(record) and curve["iters_logged_len"] == points
          and all(len(curve[k]) == points and np.isfinite(curve[k]).all()
                  for k in (*A.LOG_KEYS, "kl_weight")))
    report["train_anneal"].update(exit_code=code, readings=A.readings(curve))
    print(f"programs_left: train_anneal --iters {LEFT_ANNEAL_ITERS}: exit {code}, "
          f"{report['train_anneal']['s']:.1f} s with its corpus, launches "
          f"{report['train_anneal']['launches']}, {card}")
    anneal = report["train_anneal"]["launches"]
    if not ok or code not in (0, 1) or anneal != launch_counts(
            mel_spectrogram=6, decoder_train=anneal["decoder_train"]) or not anneal[
            "decoder_train"]:
        fail(f"programs_left train_anneal: {report['train_anneal']}, schema/finite {ok}")

    # the B=1 profile
    with torch.inference_mode():
        b1 = run("fused_b1_profile", lambda: fused_b1_profile.main(["--reps", "5"]))
    report["fused_b1_profile"].update(
        {k: b1[k] for k in ("scan", "fused_bf16", "fused_int8", "mae", "bound_bf16_ms",
                            "bound_int8_ms", "scan_launches", "fused_bf16_launches",
                            "fused_int8_launches")})
    print(f"programs_left: fused_b1_profile (10 s clip): scan {b1['scan']}, bf16 "
          f"{b1['fused_bf16']}, int8 {b1['fused_int8']}, bound bf16 {b1['bound_bf16_ms']:.4f} ms"
          f", int8 {b1['bound_int8_ms']:.4f} ms, {card}")
    scan_mae = max(m["scan"] for m in b1["mae"].values())
    if (not b1["scan_launches"]["gru_cell"] or not b1["fused_bf16_launches"]["decoder_rollout"]
            or not b1["fused_int8_launches"]["decoder_rollout"] or scan_mae > GRAPH_MAE
            or b1["cell_weights"] != CELL_PARAMS):
        fail(f"programs_left fused_b1_profile: {report['fused_b1_profile']}")

    # the train-side profilers
    reps = ["--reps", str(LEFT_REPS)]
    for label, module, which in (("loss_profile", loss_profile, ["all"]),
                                 ("grad_profile", grad_profile, ["all", "all3"]),
                                 ("train_step_profile", train_step_profile, ["all"])):
        out = run(label, lambda: module.main(which + reps))
        graphed_sections(label, out)
        # the float32 decoder under autograd (grad_profile's rollgrad and
        # dropgrad, train_step_profile's fwd) runs the training rollout's
        # kernels, eagerly and in each replay
        if label != "loss_profile" and not report[label]["launches"]["decoder_train"]:
            fail(f"programs_left {label}: no decoder_train launch: {report[label]}")
        report[label]["sections"] = {k: v for k, v in out.items()
                                     if k not in ("launches", "device")}
        print(f"programs_left: {label} {' '.join(which)}: {report[label]['s']:.1f} s, "
              f"{report[label]['sections']}, {card}")

    # the roofline of the bench's train step
    for dtype, flag in (("float32", []), ("bfloat16", ["--bf16"])):
        measured = bench["train_step_ms"][dtype]
        out = run(f"train_roofline_{dtype}", lambda: train_roofline.main(
            ["--json", "--measured-ms", str(measured)] + flag))
        keep = ("flops", "bytes_accessed", "analytic_bytes", "t_flops_ms", "t_bytes_ms",
                "bound_ms", "bound_by", "cell_params", "n_params", "peak_flops", "measured_ms",
                "fraction_of_bound", "arith_intensity_flops_per_byte")
        report[f"train_roofline_{dtype}"].update({k: out[k] for k in keep})
        print(f"programs_left: train_roofline {dtype}: {out['flops']:.4g} FLOPs, analytic "
              f"{out['analytic_bytes']:.4g} B, bound {out['bound_ms']:.3f} ms by "
              f"{out['bound_by']}, measured {measured} ms (bench), fraction "
              f"{out['fraction_of_bound']:.4f}, {card}")
        if out["cell_params"] != CELL_PARAMS or not out["flops"] > 0:
            fail(f"programs_left train_roofline {dtype}: {out}")

    # the quickstart
    qs = run("quickstart", lambda: quickstart.main([str(root / "quickstart")]))
    counts = report["quickstart"]["launches"]
    report["quickstart"].update({k: qs[k] for k in ("frames", "http_bvh_lines",
                                                    "http_batch_size", "http_latency_ms",
                                                    "wall_s")})
    print(f"programs_left: quickstart: {qs['frames']} frames, HTTP {qs['http_bvh_lines']} "
          f"lines, {qs['wall_s']:.1f} s, launches {counts}, {card}")
    if (qs["frames"] != 240 or not qs["response"]["bvh"].startswith("HIERARCHY")
            or counts["decoder_rollout"] < 2 or counts["mel_spectrogram"] < 5
            or not counts["gru_cell"]):
        fail(f"programs_left quickstart: {report['quickstart']}")
    return report


def failed_capture_raises(torch):
    """A host sync injected into the decoder step (through the pose
    integration) makes a program's capture fail: the rollout must raise,
    not hand back eager results; then a new cache captures and replays the
    chunk as the eager step computes it. Run last: a failed capture leaves
    the caching allocator's record of it behind."""
    from zeggs_tpu_torch.infer import GesturePipeline
    from zeggs_tpu_torch.infer.programs import ProgramCache
    from zeggs_tpu_torch.models import decoder as D
    from zeggs_tpu_torch.models import pose as P

    pipe = GesturePipeline(WORK / "models", WORK / "processed", device="cuda",
                           rollout_weights="float32")
    feats, n = pipe.audio_to_features(WORK / "clip_04s.wav")
    _, f0 = pipe.style_example_from_bvh(WORK / "style.bvh")
    with torch.inference_mode():
        speech = pipe.encode_speech_batched(feats[None].expand(2, -1, -1))[:, :17]
        style = torch.zeros((2, 17, pipe.style_encoding_size), device="cuda")
        state0 = [getattr(f0, k)[0:1].expand(2, *getattr(f0, k).shape[1:]).contiguous()
                  for k in ("root_pos", "root_rot", "root_vel", "root_vrt", "lpos", "ltxy",
                            "lvel", "lvrt")]
        gaze = f0.gaze_pos[0].expand(2, 17, 3)
        eager = EagerPrograms(pipe)
        carry = D.init_carry(pipe.networks["decoder"], *state0, gaze[:, 0], style[:, 0],
                             *eager.stats[:2])
        cond = (gaze[:, 1:], speech[:, 1:], style[:, 1:])
        integrate = P.devectorize_output

        def syncing(*args, **kw):
            result = integrate(*args, **kw)
            result[0].sum().item()  # waits for the card: not allowed while capturing
            return result

        P.devectorize_output = syncing
        try:
            ProgramCache(pipe.networks["decoder"], pipe.stats, pipe.dt).rollout_chunk(carry, *cond)
            error = None
        except RuntimeError as e:
            error = f"{e} ({e.__cause__})"
        finally:
            P.devectorize_output = integrate
        ref = eager.rollout_chunk(carry, *cond)[1]
        got = ProgramCache(pipe.networks["decoder"], pipe.stats, pipe.dt).rollout_chunk(
            carry, *cond)[1]
        torch.cuda.synchronize()
    after = max((a - b).abs().max().item() for a, b in zip(got, ref))
    print(f"programs: a host sync inside the step: {'raised' if error else 'did not raise'}: "
          f"{error}; a new cache afterwards against eager max|diff| {after:.3e}")
    if error is None or not after <= GRAPH_MAE:
        fail(f"programs: a failed capture did not raise ({error}) or the card broke ({after})")
    return {"raised": error, "after_max_abs_diff": after}


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def write_train_corpus():
    """A raw corpus as the pipeline reads it (original/ BVH + WAV + speaker
    timing CSV, info.csv with clap-sync timecodes that trim 0.5 s at each
    end), the v1 pipeline and options files pointing at it, under
    build/chip_smoke/train."""
    from zeggs_tpu_torch.io import bvh, wav

    root = WORK / "train"
    orig = root / "original"
    orig.mkdir(parents=True)
    rng = np.random.default_rng(SEED + 7)
    names, parents = skeleton(rng)
    rows = []
    for i in range(TRAIN_CLIPS):
        name = f"{i:03d}_Clip_{i}"
        bvh.save(orig / f"{name}.bvh", motion(rng, names, parents, int(TRAIN_SECONDS * 60)))
        wav.write_wavefile(orig / f"{name}.wav", speech_like(rng, TRAIN_SECONDS), 16000)
        with open(orig / f"{name}.csv", "w", newline="") as f:
            csv.writer(f).writerows([["#", "Start", "End"], ["R1", "0:0.0", f"0:{TRAIN_SECONDS:.1f}"]])
        rows.append(dict(audio_filename=f"{name}.wav", audio_start_time="00:00:00:00",
                         anim_start_time="00:00:00:00", acting_start_time="00:00:00:30",
                         acting_end_time=f"00:00:{int(TRAIN_SECONDS) - 1:02d}:30",
                         style=["Neutral", "Happy", "Sad"][i % 3], anim_bvh=f"{name}.bvh",
                         validation="TRUE" if i == TRAIN_CLIPS - 1 else "FALSE"))
    with open(root / "info.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    conf = json.loads((ROOT / "configs" / "data_pipeline_conf_v1.json").read_text())
    conf.update(base_path=str(root), processed_data_path="processed", save_trimmed_audio=False,
                save_trimmed_animation=False, save_normalized_animations=True)
    (root / "pipeline.json").write_text(json.dumps(conf, indent=2))
    v1 = json.loads((ROOT / "configs" / "configs_v1.json").read_text())
    v1["paths"] = {"base_path": str(root), "path_processed_data": "processed",
                   "output_dir": str(root / "run"), "models_dir": None}
    # one checkpoint and one sample synthesis: at iteration 0
    v1["train_opt"].update(generate_samples_step=1000, use_tensorboard=False)
    (root / "options.json").write_text(json.dumps(v1, indent=2))
    return root


def synth_counted(synth, eager=False):
    """Whether a sample synthesis ran decoder steps and launched the GRU
    cell once a step replayed and once a program's capture (its eager
    warm-up step), or, ``eager`` (the FiLM cell), none."""
    if not synth or not synth.get("steps"):
        return False
    if eager:
        return synth["gru_cell"] == synth["programs"] == 0
    return 0 < synth["programs"] <= 3 and synth["gru_cell"] == synth["steps"] + synth["programs"]


def instrumented_trainer(torch, base):
    """The CLI's Trainer with each train step timed and its launches counted,
    the first step's gradients checked, and the launches of sample synthesis
    counted."""
    from zeggs_tpu_torch.ops.kernels import gru_cell as GC

    class SmokeTrainer(base):
        steps, synthesis, grads = [], [], None

        def train_step(self, batch):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            metrics = super().train_step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            losses = {k: v.item() for k, v in metrics.items()}
            bad = [k for k, v in losses.items() if not np.isfinite(v)]
            if bad:
                fail(f"train step {self.iteration}: losses not finite: {bad}")
            SmokeTrainer.steps.append(dict(ms=ms, launches=read_counts(),
                                           loss=losses["total_loss"]))
            if SmokeTrainer.grads is None:
                SmokeTrainer.grads = {
                    name: (p.grad is not None and bool(torch.isfinite(p.grad).all())
                           and p.grad.abs().max().item() > 0)
                    for name, p in self.optimizer.params.items()}
            return metrics

        def generate_samples(self, n=3, length_s=30):
            g0 = GC.launches
            t0 = time.perf_counter()
            steps, programs = super().generate_samples(n, length_s)
            torch.cuda.synchronize()
            SmokeTrainer.synthesis.append(dict(steps=steps, programs=programs,
                                               gru_cell=GC.launches - g0,
                                               s=time.perf_counter() - t0))
            return steps, programs

    return SmokeTrainer


def train_phase(torch, card):
    """Phase 7: raw corpus -> `python -m zeggs_tpu_torch.cli.pipeline` ->
    `cli.train` at full v1 width for TRAIN_STEPS steps (a checkpoint and
    sample synthesis at iteration 0, a checkpoint at the end) -> a resume
    for one more step. Both CLIs run in this process, so that the launch
    counters see them. The pipeline's mel inputs are recorded as it runs and
    held, afterwards, against the plain chain."""
    from zeggs_tpu_torch.cli import pipeline as cli_pipeline
    from zeggs_tpu_torch.cli import train as cli_train
    from zeggs_tpu_torch.io import bvh, checkpoint, weights
    from zeggs_tpu_torch.ops import mel as M

    root = write_train_corpus()
    tts, mel_inputs = M.mel_spectrogram_tts, []

    def recorded_tts(x, cfg, fused=None):
        mel_inputs.append((x, cfg))
        return tts(x, cfg, fused)

    M.mel_spectrogram_tts = recorded_tts
    reset_counts()
    t0 = time.perf_counter()
    try:
        cli_pipeline.main(["-c", str(root / "pipeline.json"), "--device", "cuda"])
        torch.cuda.synchronize()
    finally:
        M.mel_spectrogram_tts = tts
    pipe_s = time.perf_counter() - t0
    pipe_counts = read_counts()
    n_aug = TRAIN_CLIPS * 2  # len_ratios 0.9 and 1.0
    print(f"pipeline: {TRAIN_CLIPS} clips of {TRAIN_SECONDS:g} s x 2 stretches, launches "
          f"{pipe_counts}; time {pipe_s:.3f} s wall, {pipe_s / TRAIN_CLIPS:.3f} s a clip "
          f"(on the card: features; on the host: BVH/WAV reading, the cubic time-stretch), {card}")
    if pipe_counts != launch_counts(mel_spectrogram=n_aug):
        fail(f"pipeline launches {pipe_counts}, expected {n_aug} mel launches")
    # the mel kernel against its plain chain on each input the pipeline gave it
    mel_err, frames = 0.0, []
    with torch.inference_mode():
        for x, cfg in mel_inputs:
            out, ref = tts(x, cfg), tts(x, cfg, fused=False)
            err = (out - ref).abs().max().item()
            if not (torch.isfinite(out).all() and out.shape == ref.shape and err <= MEL_TOL):
                fail(f"mel_spectrogram on a pipeline input of {x.shape[0]} samples: "
                     f"kernel/plain error {err} > {MEL_TOL}")
            mel_err, frames = max(mel_err, err), frames + [out.shape[0]]
    if len(mel_inputs) != n_aug:
        fail(f"the pipeline computed {len(mel_inputs)} mel spectrograms, expected {n_aug}")
    print(f"mel_spectrogram on the pipeline's {len(mel_inputs)} inputs ({min(frames)}-"
          f"{max(frames)} frames, n_fft {mel_inputs[0][1].filter_length}): max|err| "
          f"{mel_err:.3e} (tol {MEL_TOL:g})")
    # the debug artifacts: data_info.html and two BVHs a clip and stretch
    processed = root / "processed"
    html = (processed / "data_info.html").read_text()
    debug = sorted((processed / "normalized_animations").glob("*.bvh"))
    finite = all(np.isfinite(bvh.load(f)["rotations"]).all() for f in debug)
    print(f"pipeline debug artifacts: data_info.html {len(html)} bytes, {len(debug)} normalised "
          f"BVHs (root-relative and root-baked), finite {finite}")
    if "Data Info" not in html or len(debug) != 2 * n_aug or not finite:
        fail(f"pipeline debug artifacts: {len(debug)} BVHs, html {len(html)} bytes")

    base = cli_train.Trainer
    Smoke = cli_train.Trainer = instrumented_trainer(torch, base)
    argv = ["-o", str(root / "options.json"), "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    first = cli_train.main(argv + ["--max-iterations", str(TRAIN_STEPS)])
    peak = torch.cuda.max_memory_allocated() / 2**20
    steps, synth = list(Smoke.steps), list(Smoke.synthesis)
    missing = [k for k, ok in (Smoke.grads or {}).items() if not ok]
    n_params = len(first.optimizer.params)
    if Smoke.grads is None or missing:
        fail(f"parameters without a finite nonzero gradient in the first step: {missing}")
    nets_cfg = first.opts.net
    print(f"train: v1 widths (H={nets_cfg.decoder.nhidden}, {nets_cfg.style_encoder.type} "
          f"{nets_cfg.style_encoder.nhidden}/{nets_cfg.style_encoder.style_encoding_size} + VAE, "
          f"batch {first.opts.train.batchsize}, window {first.opts.train.window}), "
          f"{len(first.ds)} windows; every one of {n_params} parameters got a finite nonzero "
          f"gradient in the first step; losses {[round(s['loss'], 4) for s in steps]}")
    per_step = launch_counts(decoder_train=bptt_launches(first.ds.window - 1))
    if any(s["launches"] != per_step for s in steps):
        fail(f"train steps launched {[s['launches'] for s in steps]}, expected {per_step} each")
    if len(synth) != 1 or not synth_counted(synth[0]):
        fail(f"sample synthesis: {synth}")
    samples = sorted((root / "run" / "logs" / "samples").glob("*.bvh"))
    for path in samples:
        anim = bvh.load(path)
        if not (np.isfinite(anim["positions"]).all() and np.isfinite(anim["rotations"]).all()):
            fail(f"sample {path.name} is not finite")
    ms = [s["ms"] for s in steps]
    graph = graph_stats(first.program)
    print(f"time train step through the CLI (v1 width, wall with a cuda.synchronize): the eager "
          f"warm-up {ms[0]:.1f} ms, the capture and first replay {ms[1]:.1f} ms, median of the "
          f"next {len(ms) - 2} replays {np.median(ms[2:]):.1f} ms "
          f"({', '.join(f'{m:.1f}' for m in ms[2:])}); launches a step {steps[1]['launches']}; "
          f"capture {graph['capture_s']:.3f} s, {graph['kernels'][0]} kernels of "
          f"{graph['nodes'][0]} nodes, graph pool {graph['graph_mib']:.1f} MiB; peak device "
          f"memory {peak:.1f} MiB, {card}")
    print(f"time sample synthesis at iteration 0: {len(samples)} BVHs, {synth[0]['steps']} decoder "
          f"steps, {synth[0]['gru_cell']} GRU-cell launches ({synth[0]['programs']} program "
          f"captures), {synth[0]['s']:.3f} s, {card}")

    # resume for one more step: every piece of the loop state comes back
    options = json.loads((root / "options.json").read_text())
    options["train_opt"]["resume"] = True
    (root / "options_resume.json").write_text(json.dumps(options, indent=2))
    Smoke.steps.clear()
    second = cli_train.main(["-o", str(root / "options_resume.json"), "--device", "cuda",
                             "--max-iterations", str(TRAIN_STEPS + 1)])
    nets, _, meta = checkpoint.load_train_state(root / "run" / "saved_models" / str(TRAIN_STEPS))
    restored = (
        meta["step"] == TRAIN_STEPS and second.iteration == TRAIN_STEPS + 1
        and second.epoch >= first.epoch and second.optimizer.step_count == TRAIN_STEPS + 1
        and len(Smoke.steps) == 1 and np.isfinite(Smoke.steps[0]["loss"])
        and meta["np_rng_state"] == first.rng.bit_generator.state
        and meta["torch_generator_state"] == first.generator.get_state().tolist()
    )
    first_params = {k: p.detach().cpu().numpy() for k, p in first.optimizer.params.items()}
    saved = {f"{n}.{k}": v.numpy() for n, tree in nets.items()
             for k, v in weights.from_jax(tree).items()}
    restored = restored and set(saved) == set(first_params) and all(
        np.array_equal(saved[k], v) for k, v in first_params.items())
    print(f"resume: checkpoint at iteration {meta['step']} restored (parameters, RAdam state, "
          f"epoch, data-order RNG, dropout generator): {restored}; one more step, loss "
          f"{Smoke.steps[0]['loss'] if Smoke.steps else None}")
    if not restored:
        fail("the resumed checkpoint did not restore the training state")
    cli_train.Trainer = base
    del second
    graphed = graphed_vs_eager(torch, first, card)
    synthesis = synthesis_turns(torch, first, card)
    breakdown = step_breakdown(torch, first, card)
    return dict(breakdown=breakdown, graphed=graphed, synthesis=synthesis,
                pipeline_mel=pipe_counts["mel_spectrogram"],
                pipeline_mel_err=mel_err, pipeline_s_per_clip=pipe_s / TRAIN_CLIPS,
                step_ms=float(np.median(ms[2:])), first_step_ms=ms[0], capture_step_ms=ms[1],
                launches_per_step=steps[1]["launches"], peak_mib=peak, graph=graph,
                synthesis_gru=synth[0]["gru_cell"], synthesis_steps=synth[0]["steps"],
                synthesis_programs=synth[0]["programs"])


def graph_stats(program):
    """A train program's capture: seconds, its graphs' pool memory and
    their kernel and node counts."""
    from zeggs_tpu_torch.bench.train import graph_kernels

    counts = [graph_kernels(g) for g in program.graphs]
    return dict(capture_s=program.capture_seconds, graph_mib=program.graph_bytes / 2**20,
                graphs=len(counts), kernels=[k for k, _ in counts], nodes=[n for _, n in counts])


def device_batch(torch, trainer, inputs):
    """The batch a trainer's program gathers (or copies) from ``inputs``,
    built eagerly for the plain step."""
    if trainer.device_corpus is None:
        return {k: torch.as_tensor(v, device=trainer.device) for k, v in inputs.items()}
    x = {k: torch.as_tensor(np.asarray(v), device=trainer.device) for k, v in inputs.items()}
    if "labels" in x:
        return trainer.device_corpus.gather_batch(x["window_starts"], labels=x["labels"],
                                                  nlabels=trainer.ds.nlabels)
    return trainer.device_corpus.gather_batch(x["window_starts"], x["ex_idx"], x["ex_lengths"])


def graphed_vs_eager(torch, trainer, card):
    """The trainer's captured program against the plain eager step
    (`train.loop.make_train_step`) on a copy of the same state (networks,
    RAdam state, noise generator), in turns on the same inputs: one replay,
    then one eager step, GRAPH_ROUNDS times. After TRAIN_COMPARED rounds the
    parameters, RAdam moments, losses and generator states must be equal
    bit for bit, or within TRAIN_RTOL / TRAIN_ATOL with the difference
    named; then the card's busy share over BUSY_REPLAYS more replays,
    from torch.profiler."""
    import copy

    from zeggs_tpu_torch.bench.train import device_events
    from zeggs_tpu_torch.train import loop

    program, ds, opts = trainer.program, trainer.ds, trainer.opts
    if len(program.graphs) != 1:
        fail(f"the trainer's program holds {len(program.graphs)} graphs, expected 1")

    def eager_copy():
        nets = copy.deepcopy(trainer.nets)
        optimizer, plain = loop.make_train_step(opts, ds.stats, ds.parents, ds.dt, nets)
        optimizer.load_state(*trainer.optimizer.state())
        generator = torch.Generator(device=trainer.device)
        generator.set_state(trainer.generator.get_state())
        return optimizer, plain, generator

    # a second eager copy for the first TRAIN_COMPARED rounds: how far two
    # eager runs from one state lie apart
    (optimizer, plain, generator), (optimizer2, plain2, generator2) = eager_copy(), eager_copy()
    rng = np.random.default_rng(SEED + 21)
    graphed_ms, eager_ms, losses, compared = [], [], [], None

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()["total_loss"]
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def pairs():
        out = [(p, optimizer.params[k]) for k, p in trainer.optimizer.params.items()]
        out += [(m, optimizer.exp_avg[k]) for k, m in trainer.optimizer.exp_avg.items()]
        out += [(v, optimizer.exp_avg_sq[k]) for k, v in trainer.optimizer.exp_avg_sq.items()]
        return out + losses

    def draw():
        idx = rng.permutation(len(ds))[: opts.train.batchsize]
        return trainer._batch(idx, ds.sample_example_length(rng))

    for i in range(GRAPH_ROUNDS):
        inputs, it = draw(), trainer.iteration + i
        loss_g, ms_g = timed(lambda: program.run(inputs, it))
        loss_e, ms_e = timed(lambda: plain(device_batch(torch, trainer, inputs), it, generator))
        graphed_ms.append(ms_g)
        eager_ms.append(ms_e)
        losses.append((loss_g, loss_e))
        if i < TRAIN_COMPARED:
            plain2(device_batch(torch, trainer, inputs), it, generator2)
        if i + 1 == TRAIN_COMPARED:
            both = pairs()
            worst = max((a - b).abs().max().item() for a, b in both)
            excess = max(((a - b).abs() - (TRAIN_ATOL + TRAIN_RTOL * b.abs())).max().item()
                         for a, b in both)
            eager_worst = max((optimizer2.params[k] - p).abs().max().item()
                              for k, p in optimizer.params.items())
            compared = dict(bitwise=all(torch.equal(a, b) for a, b in both), worst_abs_diff=worst,
                            worst_excess=excess, eager_vs_eager_params=eager_worst,
                            generator_state_equal=bool(torch.equal(
                                trainer.generator.get_state(), generator.get_state())))
            del optimizer2, plain2
    print(f"train graphed against eager (v1 width, B={opts.train.batchsize}, window "
          f"{opts.train.window}, examples {ds.max_example_length} wide; the same inputs and noise "
          f"from one state): after {TRAIN_COMPARED} steps parameters, RAdam moments and losses "
          f"bit for bit equal {compared['bitwise']}, worst |diff| {compared['worst_abs_diff']:.3e}, "
          f"worst excess over atol {TRAIN_ATOL:g} + rtol {TRAIN_RTOL:g} * |eager| "
          f"{compared['worst_excess']:.3e} (must be <= 0); generator states equal "
          f"{compared['generator_state_equal']}; a second eager copy's parameters against the "
          f"first's worst |diff| {compared['eager_vs_eager_params']:.3e} (cuDNN's default "
          f"algorithms)")
    if not (compared["worst_excess"] <= 0 and compared["generator_state_equal"]):
        fail(f"the graphed train step differs from the eager step: {compared}")
    g, e = float(np.median(graphed_ms)), float(np.median(eager_ms))
    print(f"time train step (v1 width, B={opts.train.batchsize}, window {opts.train.window}; host "
          f"clock closed by a cuda.synchronize, in turns on the same inputs): graphed median "
          f"{g:.1f} ms of {len(graphed_ms)} replays ({', '.join(f'{m:.1f}' for m in graphed_ms)}), "
          f"eager median {e:.1f} ms of {len(eager_ms)} steps "
          f"({', '.join(f'{m:.1f}' for m in eager_ms)}); {e / g:.2f}x, {card}")

    replays = [draw() for _ in range(BUSY_REPLAYS)]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i, inputs in enumerate(replays):
            program.run(inputs, trainer.iteration + GRAPH_ROUNDS + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = device_events(prof)
    copies = [n for n, _ in device if "memcpy" in n.lower() or "memset" in n.lower()]
    busy_ms = sum(us for _, us in device) / 1e3
    busy = dict(replays=BUSY_REPLAYS, wall_ms=wall, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall, kernels_per_replay=(len(device) - len(copies))
                / BUSY_REPLAYS, copies_per_replay=len(copies) / BUSY_REPLAYS)
    print(f"train step replays under torch.profiler: {BUSY_REPLAYS} replays in {wall:.1f} ms wall, "
          f"{busy['kernels_per_replay']:.0f} kernels and {busy['copies_per_replay']:.0f} copies "
          f"or sets a replay, card busy {busy_ms:.1f} ms ({busy_ms / wall:.1%}), {card}")
    return dict(compared=compared, graphed_ms=graphed_ms, eager_ms=eager_ms, graphed_median_ms=g,
                eager_median_ms=e, busy=busy, graph=graph_stats(program))


def synthesis_turns(torch, trainer, card):
    """`Trainer.generate_samples` through the rollout programs and through
    the eager rollout (`EagerRollouts` in the cache's place), in turns G E
    G, each into its own directory: seconds, launches, and the graphed
    BVHs against the eager ones (GRAPH_MAE)."""
    from zeggs_tpu_torch.ops.kernels import gru_cell as GC
    from zeggs_tpu_torch.train import loop

    base, out = trainer.samples_dir, {"graphed": [], "eager": []}
    cache = loop.ProgramCache
    try:
        for i, how in enumerate(("graphed", "eager", "graphed")):
            trainer.samples_dir = base.parent / f"samples_{how}_{i}"
            trainer.samples_dir.mkdir()
            loop.ProgramCache = cache if how == "graphed" else EagerRollouts
            g0 = GC.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps, programs = trainer.generate_samples(3)
            torch.cuda.synchronize()
            out[how].append(dict(s=time.perf_counter() - t0, steps=steps, programs=programs,
                                 gru_cell=GC.launches - g0, dir=trainer.samples_dir))
    finally:
        loop.ProgramCache, trainer.samples_dir = cache, base
    g, e = out["graphed"][0], out["eager"][0]
    maes = [bvh_mae(torch, a, g["dir"] / a.name) for a in sorted(e["dir"].glob("*predict*.bvh"))]
    print(f"time sample synthesis ({g['steps']} decoder steps, 12 BVHs): graphed "
          f"{', '.join(f'{r['s']:.3f}' for r in out['graphed'])} s ({g['gru_cell']} GRU-cell "
          f"launches: {g['steps']} replayed, {g['programs']} captures), eager {e['s']:.3f} s "
          f"({e['gru_cell']} launches); graphed against eager predictions BVH MAE max "
          f"{max(maes):.3e} (bound {GRAPH_MAE:g}), {card}")
    if not (synth_counted(g) and e["gru_cell"] == e["steps"] == g["steps"]
            and len(maes) == 6 and max(maes) <= GRAPH_MAE):
        fail(f"sample synthesis graphed against eager: {out}, MAEs {maes}")
    return dict(graphed_s=[r["s"] for r in out["graphed"]], eager_s=e["s"], steps=g["steps"],
                programs=g["programs"], gru_cell=g["gru_cell"], max_bvh_mae=float(max(maes)))


def step_breakdown(torch, trainer, card):
    """Where one v1-width eager train step's time goes (the plain step that
    the trainer's program replaces), on a batch of the corpus: the loss's
    forward (encoders, rollout, the 18 terms; the terms alone timed apart),
    the backward and the RAdam update, each closed by a cuda.synchronize;
    then one eager step under torch.profiler: kernel launches, host-to-
    device copies and the card's busy share (kernel time over the step's
    wall time). First one step as the program runs it, eagerly, under
    `torch.cuda.set_sync_debug_mode("error")`: it must not synchronise.
    Runs last on ``trainer``: the eager steps rebind the
    gradients its program captured."""
    from zeggs_tpu_torch.bench.train import device_events
    from zeggs_tpu_torch.train import loop, loss as L

    ds = trainer.ds
    idx = np.random.default_rng(SEED).permutation(len(ds))[: trainer.opts.train.batchsize]
    batch = device_batch(torch, trainer, trainer._batch(idx, ds.max_example_length))
    loss_fn = loop.make_loss_fn(trainer.opts, ds.stats, ds.parents, ds.dt)
    nets, opt, gen = trainer.nets, trainer.optimizer, trainer.generator

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def step():
        for p in opt.params.values():
            p.grad = None
        loss, _ = loss_fn(nets, batch, trainer.iteration, gen)
        loss.backward()
        opt.step()

    step()  # warm: the loss's statistics and the positional table reach the card
    # the step as the program runs it (the iteration and RAdam's scalars on
    # the card) synchronises nowhere: nothing that a capture would refuse
    scalars = torch.from_numpy(opt.scalars()).to(trainer.device)
    iteration = torch.tensor(float(trainer.iteration), device=trainer.device)
    for p in opt.params.values():
        p.grad = None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss_fn(nets, batch, iteration, gen)[0].backward()
        opt.apply(scalars)
    except RuntimeError as e:
        fail(f"the train step synchronises with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    opt.step_count += 1
    print("train step: no host sync under torch.cuda.set_sync_debug_mode('error') (v1 width)")
    rows = []
    for _ in range(3):
        for p in opt.params.values():
            p.grad = None
        loss, fwd = timed(lambda: loss_fn(nets, batch, trainer.iteration, gen)[0])
        _, bwd = timed(loss.backward)
        _, upd = timed(opt.step)
        rows.append((fwd, bwd, upd))
    fwd, bwd, upd = (float(np.median(c)) for c in zip(*rows))
    # the 18 terms alone, on trajectories that need their gradient
    out = {k: batch[k].clone().requires_grad_() for k in loop.POSE_KEYS}
    tgt = {k: batch[k] for k in loop.POSE_KEYS}
    parents = [int(p) for p in ds.parents]
    terms = float(np.median([timed(lambda: L.compute_loss(out, tgt, batch["gaze_pos"], parents,
                                                           ds.dt)[0])[1] for _ in range(3)]))

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, wall = timed(step)
    device = device_events(prof)
    copies = [n for n, _ in device if "memcpy" in n.lower()]
    busy_ms = sum(us for _, us in device) / 1e3
    kernels = len(device) - len(copies)
    report = dict(forward_ms=fwd, loss_terms_ms=terms, backward_ms=bwd, optimizer_ms=upd,
                  profiled_step_ms=wall, kernels=kernels, copies=len(copies),
                  device_busy_ms=busy_ms, busy_share=busy_ms / wall)
    print(f"time eager train step breakdown (v1 width, B={len(idx)}, example {ds.max_example_length} "
          f"frames; medians of 3, each phase closed by a cuda.synchronize): forward {fwd:.1f} ms "
          f"(of which the 18 loss terms {terms:.1f} ms), backward {bwd:.1f} ms, RAdam "
          f"{upd:.1f} ms; one profiled step {wall:.1f} ms: {kernels} kernels, {len(copies)} "
          f"copies, card busy {busy_ms:.1f} ms ({busy_ms / wall:.1%}), {card}")
    return report


def grad_card_vs_cpu(torch):
    """One deterministic small-width step's gradients on the card against
    the same step on the CPU, per leaf within GRAD_TOL of max(1, max|g|)."""
    from zeggs_tpu_torch.config import Options
    from zeggs_tpu_torch.train import loop

    rng = np.random.default_rng(SEED + 11)
    names, parents = skeleton(rng, 8)
    J, B, T, L = len(names), 4, 32, 48
    pose_in, pose_out = 6 + 15 * J + 3, 6 + 15 * J
    opts = Options.from_options_dict({"net_opt": {
        "decoder": {"nhidden": 64}, "speech_encoder": {"nhidden": 16, "speech_encoding_size": 16},
        "style_encoder": {"nhidden": 24, "style_encoding_size": 8, "example_length": 24}}})
    stats = dict(audio_input_mean=rng.normal(size=81) * 0.1, audio_input_std=np.float32(1.5),
                 anim_input_mean=rng.normal(size=pose_in) * 0.1,
                 anim_input_std=rng.uniform(0.5, 2.0, pose_in),
                 anim_output_mean=rng.normal(size=pose_out) * 0.1,
                 anim_output_std=rng.uniform(0.05, 0.5, pose_out))
    q = rng.normal(size=(B, T, 4))
    batch = dict(root_pos=rng.normal(size=(B, T, 3)) * 10, root_rot=q / np.linalg.norm(q, axis=-1,
                                                                                     keepdims=True),
                 root_vel=rng.normal(size=(B, T, 3)), root_vrt=rng.normal(size=(B, T, 3)),
                 lpos=rng.normal(size=(B, T, J, 3)), ltxy=rng.normal(size=(B, T, J, 2, 3)),
                 lvel=rng.normal(size=(B, T, J, 3)), lvrt=rng.normal(size=(B, T, J, 3)),
                 audio_features=rng.normal(size=(B, T, 81)),
                 gaze_pos=np.repeat(rng.normal(size=(B, 1, 3)) * 100, T, axis=1),
                 example=rng.normal(size=(B, L, pose_in)))
    dims = dict(num_audio_features=81, pose_input_size=pose_in, pose_output_size=pose_out)
    grads = {}
    for dev in ("cpu", "cuda"):
        nets = loop.init_networks(opts, dims, 3, SEED, dev)
        b = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev) for k, v in batch.items()}
        b["example_lengths"] = torch.tensor([L, 40, 31, 24], device=dev)
        loss, _ = loop.make_loss_fn(opts, stats, parents, DT, deterministic=True)(nets, b, 7500)
        loss.backward()
        grads[dev] = {k: p.grad.cpu() for k, p in loop.named_parameters(nets).items()}
    worst = max(((grads["cuda"][k] - g).abs().max().item() / max(1.0, g.abs().max().item()), k)
                for k, g in grads["cpu"].items())
    print(f"train step gradients, card against CPU ({len(grads['cpu'])} leaves, TF32 off): worst "
          f"max|diff| / max(1, max|g|) {worst[0]:.3e} at {worst[1]} (tol {GRAD_TOL:g})")
    if not worst[0] <= GRAD_TOL:
        fail(f"card against CPU gradients: {worst}")
    return worst[0]


# ---------------------------------------------------------------------------
# reference checkpoints, multi-process training, Griffin-Lim
# ---------------------------------------------------------------------------

def trees_equal(a, b):
    from zeggs_tpu_torch.io import checkpoint

    fa, fb = checkpoint._flatten(a), checkpoint._flatten(b)
    return fa.keys() == fb.keys() and all(
        v.shape == fb[k].shape and np.array_equal(v, fb[k]) for k, v in fa.items())


def reference_checkpoints(torch, card):
    """The fixture's networks written as the reference's whole-module .pt
    pickles; `cli.convert` on them must give the fixture's .npz trees, array
    for array; `cli.generate` on the card from a directory of only the .pt
    files must write the .npz directory's BVH, which `cli.compare --json`
    must report. Launch counts of each request."""
    from zeggs_tpu_torch.cli import compare as cli_compare
    from zeggs_tpu_torch.cli import convert as cli_convert
    from zeggs_tpu_torch.cli import generate as cli_generate
    from zeggs_tpu_torch.io import checkpoint, torch_compat

    trees = {n: checkpoint.load(WORK / "models" / f"{n}.npz")[0] for n in NETWORKS}
    pt_dir, converted = WORK / "pt_models", WORK / "converted"
    torch_compat.save_reference_networks(pt_dir, trees)
    cli_convert.main(["--src", str(pt_dir), "--dst", str(converted)])
    bad = [n for n, tree in trees.items()
           if not trees_equal(checkpoint.load(converted / f"{n}.npz")[0], tree)]
    if sorted(p.name for p in pt_dir.iterdir()) != sorted(f"{n}.pt" for n in NETWORKS) or bad:
        fail(f"reference checkpoints: converted trees differ from the fixture's: {bad}")
    options = json.loads((WORK / "options.json").read_text())
    options["paths"]["models_dir"] = str(pt_dir)
    (WORK / "options_pt.json").write_text(json.dumps(options, indent=2))
    out, counts, wall = WORK / "results" / "reference_checkpoints", {}, {}
    for tag, opts in (("npz", WORK / "options.json"), ("pt", WORK / "options_pt.json")):
        reset_counts()
        t0 = time.perf_counter()
        cli_generate.main(["-o", str(opts), "-s", str(WORK / "style.bvh"),
                           "-a", str(WORK / "clip_10s.wav"), "-n", tag, "-p", str(out),
                           "-r", str(SEED), "--device", "cuda"])
        torch.cuda.synchronize()
        wall[tag], counts[tag] = time.perf_counter() - t0, read_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_compare.main([str(out / "npz.bvh"), str(out / "pt.bvh"), "--json", "--device", "cuda"])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    same = (out / "npz.bvh").read_text() == (out / "pt.bvh").read_text()
    print(f"reference checkpoints: {len(trees)} networks as .pt pickles, converted back equal "
          f"array for array; 10 s request from the .pt directory: launches {counts['pt']} "
          f"(.npz directory {counts['npz']}), CLI wall {wall['pt']:.3f} s (pipeline load "
          f"included); BVH text identical {same}; compare --json {report}")
    expected = launch_counts(decoder_rollout=1, mel_spectrogram=1)
    errors = [report.get(k) for k in ("rotation_mae_deg", "position_mae",
                                      "joint_position_error_max")]
    if counts["pt"] != expected or counts["npz"] != expected:
        fail(f"reference checkpoints: launches {counts}, expected {expected} a request")
    if not (same and report.get("comparable") and errors == [0.0, 0.0, 0.0]):
        fail(f"reference checkpoints: the .pt request differs from the .npz one: {report}")
    return dict(launches=counts["pt"], compare=report)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_options(train_root, name):
    """The training phase's v1 options at the multi-process phase's batch,
    window and output directory."""
    v1 = json.loads((train_root / "options.json").read_text())
    v1["train_opt"].update(batchsize=DDP_BATCH, window=DDP_WINDOW)
    v1["paths"]["output_dir"] = str(train_root / name)
    path = train_root / f"{name}.json"
    path.write_text(json.dumps(v1, indent=2))
    return path


def short_trainer(torch, base):
    """The CLI's Trainer with short sample synthesis, its GRU-cell launches
    counted, each train step timed and its losses kept, and the process
    group's backend and an all-reduce checked."""
    from zeggs_tpu_torch.ops.kernels import gru_cell as GC
    from zeggs_tpu_torch.parallel import distributed

    class ShortTrainer(base):
        record = dict(steps_ms=[], finite=[], losses=[], synthesis=None, backend=None,
                      all_reduce=None)

        def train_step(self, batch):
            rec = ShortTrainer.record
            if torch.distributed.is_initialized() and rec["backend"] is None:
                probe = torch.ones(1, device=self.device) * (self.rank + 1)
                torch.distributed.all_reduce(probe)
                rec["backend"], rec["all_reduce"] = torch.distributed.get_backend(), probe.item()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = super().train_step(batch)
            torch.cuda.synchronize()
            rec["steps_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["finite"].append(all(bool(torch.isfinite(v)) for v in metrics.values()))
            rec["losses"].append(metrics["total_loss"].item())
            return metrics

        def generate_samples(self, n=3, length_s=30):
            g0 = GC.launches
            steps, programs = super().generate_samples(DDP_SAMPLES, DDP_SAMPLE_S)
            torch.cuda.synchronize()
            if distributed.process_index() == 0:
                ShortTrainer.record["synthesis"] = dict(steps=steps, programs=programs,
                                                        gru_cell=GC.launches - g0)
            return steps, programs

    return ShortTrainer


def ddp_worker(argv):
    """One of the two processes of the multi-process phase:
    `chip_smoke.py --ddp-worker address rank options host_batches`."""
    import torch

    from zeggs_tpu_torch.cli import train as cli_train

    address, rank, options, host_batches = argv
    torch.set_num_threads(2)
    cli_train.Trainer = Trainer = short_trainer(torch, cli_train.Trainer)
    trainer = cli_train.main(
        ["-o", options, "--device", "cuda", "--max-iterations", str(DDP_STEPS),
         "--coordinator-address", address, "--num-processes", "2", "--process-id", rank,
         "--dist-backend", "gloo"] + (["--host-batches"] if int(host_batches) else []))
    print("DDP_WORKER " + json.dumps({**Trainer.record, "rank": int(rank),
                                      "device": str(trainer.device),
                                      "iteration": trainer.iteration,
                                      "graph": graph_stats(trainer.program)}), flush=True)


def ddp_phase(torch, card, train_root):
    """Two processes sharing the card over gloo (`cli.train` with the three
    multi-process flags), B=32, 3 steps, on both data paths, against one
    process at B=32; then one NCCL process for one step, joined from
    torchrun's variables."""
    from zeggs_tpu_torch.cli import train as cli_train
    from zeggs_tpu_torch.io import checkpoint

    base = cli_train.Trainer
    report = {}
    try:
        for path in ("host_batches", "device_corpus"):
            host = path == "host_batches"
            multi = ddp_options(train_root, f"ddp_{path}")
            address = f"127.0.0.1:{free_port()}"
            t0 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--ddp-worker", address, str(r),
                 str(multi), str(int(host))], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
            try:
                outs = [p.communicate(timeout=DDP_TIMEOUT_S)[0] for p in procs]
            except subprocess.TimeoutExpired:
                fail(f"ddp {path}: the processes did not finish in {DDP_TIMEOUT_S} s")
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.communicate()
            wall = time.perf_counter() - t0
            for r, (p, out) in enumerate(zip(procs, outs)):
                if p.returncode != 0:
                    fail(f"ddp {path}: process {r} exited {p.returncode}:\n{out[-3000:]}")
            recs = [json.loads(line.split(" ", 1)[1]) for out in outs
                    for line in out.splitlines() if line.startswith("DDP_WORKER ")]
            rank0 = next(r for r in recs if r["rank"] == 0)

            cli_train.Trainer = Single = short_trainer(torch, base)
            single = ddp_options(train_root, f"single_{path}")
            one = cli_train.main(["-o", str(single), "--device", "cuda", "--max-iterations",
                                  str(DDP_STEPS)] + (["--host-batches"] if host else []))
            one_graphs = len(one.program.graphs)
            del one
            cli_train.Trainer = base
            a, _, meta_a = checkpoint.load_train_state(train_root / f"ddp_{path}" / "saved_models")
            b, _, meta_b = checkpoint.load_train_state(train_root / f"single_{path}" /
                                                       "saved_models")
            fa, fb = checkpoint._flatten(a), checkpoint._flatten(b)
            worst = max(float(np.abs(v - fb[k]).max()) for k, v in fa.items())
            close = fa.keys() == fb.keys() and all(
                np.allclose(v, fb[k], rtol=DDP_RTOL, atol=DDP_ATOL) for k, v in fa.items())
            state = (meta_a["np_rng_state"] == meta_b["np_rng_state"]
                     and meta_a["torch_generator_state"] == meta_b["torch_generator_state"])
            synth = rank0["synthesis"] or {}
            # the last step is a replay: the first is the eager warm-up, the
            # second the capture and its first replay
            two, one = rank0["steps_ms"][-1], Single.record["steps_ms"][-1]
            graphs = [r["graph"]["graphs"] for r in recs]
            print(f"ddp {path}: 2 processes on one card (gloo; {[r['device'] for r in recs]}), "
                  f"B={DDP_BATCH} ({DDP_BATCH // 2} rows a process), window {DDP_WINDOW}, "
                  f"{DDP_STEPS} steps (an eager warm-up, then graphs A and B replayed around the "
                  f"eager all-reduce: {graphs} graphs a process, kernels "
                  f"{rank0['graph']['kernels']}; one process {one_graphs} graph), "
                  f"against 1 process: worst |diff| {worst:.3e} (rtol "
                  f"{DDP_RTOL:g}, atol {DDP_ATOL:g}), generator states equal {state}; rank 0's "
                  f"sample synthesis {synth.get('steps')} decoder steps, {synth.get('gru_cell')} "
                  f"GRU-cell launches; all-reduce of (1, 2) {rank0['all_reduce']}")
            print(f"time ddp {path} step (v1 width, B={DDP_BATCH}, window {DDP_WINDOW}; the last "
                  f"step, a replay): 2 processes on one card {two:.1f} ms "
                  f"({', '.join(f'{m:.1f}' for m in rank0['steps_ms'])}), 1 process {one:.1f} ms "
                  f"({', '.join(f'{m:.1f}' for m in Single.record['steps_ms'])}); the pair's "
                  f"wall {wall:.1f} s with start-up, {card}")
            if (len(recs) != 2 or any(r["iteration"] != DDP_STEPS for r in recs)
                    or graphs != [2, 2] or one_graphs != 1):
                fail(f"ddp {path}: {recs}, one process's graphs {one_graphs}")
            if not (close and state):
                fail(f"ddp {path}: 2 processes differ from 1: worst {worst}, states {state}")
            if rank0["all_reduce"] != 3.0 or not synth_counted(synth):
                fail(f"ddp {path}: all-reduce {rank0['all_reduce']}, synthesis {synth}")
            report[path] = dict(worst_abs_diff=worst, step_ms_2proc=two, step_ms_1proc=one,
                                synthesis=synth, graph=rank0["graph"])

        # one NCCL process (the default backend on a card) for two steps (the
        # eager warm-up, then the captured step), joined as torchrun joins it:
        # its variables set and none of the three flags
        cli_train.Trainer = Nccl = short_trainer(torch, base)
        nccl = ddp_options(train_root, "ddp_nccl")
        torchrun_env = dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(free_port()), LOCAL_RANK="0")
        saved = {k: os.environ.get(k) for k in torchrun_env}
        os.environ.update(torchrun_env)
        try:
            trainer = cli_train.main(["-o", str(nccl), "--device", "cuda", "--max-iterations", "2"])
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        rec, graphs = Nccl.record, len(trainer.program.graphs)
        print(f"ddp nccl: 1 process from torchrun's variables on {trainer.device}, backend "
              f"{rec['backend']}, all-reduce {rec['all_reduce']}, {graphs} graph; time the eager "
              f"warm-up step {rec['steps_ms'][0]:.1f} ms, the captured step (capture and replay) "
              f"{rec['steps_ms'][1]:.1f} ms (v1 width, B={DDP_BATCH}, window {DDP_WINDOW}), {card}")
        if (rec["backend"] != "nccl" or rec["all_reduce"] != 1.0 or len(rec["steps_ms"]) != 2
                or trainer.device != torch.device("cuda", 0) or graphs != 1
                or not all(rec["finite"])):
            fail(f"ddp nccl: {rec}, device {trainer.device}, graphs {graphs}")
        del trainer
        if torch.distributed.is_initialized():
            fail("ddp nccl: the CLI left its process group")
        report["nccl"] = dict(steps_ms=rec["steps_ms"], backend=rec["backend"], graphs=graphs)
    finally:
        cli_train.Trainer = base
    return report


def griffin_lim_phase(torch, card):
    """The 10 s clip's mel spectrogram from the mel kernel, undone to a
    linear magnitude, and Griffin-Lim (30 iterations) on the card against
    the same call on the CPU from the same first signal."""
    from zeggs_tpu_torch.config import load_pipeline_conf
    from zeggs_tpu_torch.ops import mel as M

    cfg, _ = load_pipeline_conf(WORK / "processed" / "data_pipeline_conf.json")
    x = torch.as_tensor(read_wav("clip_10s"), device="cuda")
    reset_counts()
    mel_db = M.mel_spectrogram_tts(x, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    amp = M.db_to_amplitude(M.denormalize_range(mel_db, cfg.min_clipping / cfg.filter_length))
    mag = M.mel_to_linear(amp, cfg.sampling_rate, cfg.filter_length, cfg.mel_fmin, cfg.mel_fmax)
    hop, n_fft = cfg.hop_length, cfg.filter_length
    n = int(mag.shape[0] * hop + n_fft)
    signal = np.random.default_rng(SEED).standard_normal(n).astype(np.float32)

    def on_card():
        return M.griffin_lim(mag, hop, n_fft, GL_ITERATIONS, signal=signal)

    y = on_card()
    t0 = time.perf_counter()
    y_cpu = M.griffin_lim(mag.cpu(), hop, n_fft, GL_ITERATIONS, signal=signal)
    cpu_s = time.perf_counter() - t0
    err = float(np.linalg.norm(y.cpu().numpy() - y_cpu.numpy()) / np.linalg.norm(y_cpu.numpy()))
    ms = min(event_ms(torch, on_card, 3) for _ in range(2))
    print(f"griffin_lim: 10 s clip, {mag.shape[0]} frames x {mag.shape[1]} bins from the mel "
          f"kernel (launches {counts}), {GL_ITERATIONS} iterations, {n} samples: card against "
          f"CPU relative L2 error {err:.3e} (tol {GL_TOL:g}); time {ms:.2f} ms on the card "
          f"(CUDA events), {cpu_s * 1e3:.1f} ms on the CPU, {card}")
    if counts["mel_spectrogram"] != 1 or not (np.isfinite(y.cpu().numpy()).all() and err < GL_TOL):
        fail(f"griffin_lim: launches {counts}, relative error {err}")
    return dict(ms=ms, cpu_ms=cpu_s * 1e3, rel_l2_err=err, frames=int(mag.shape[0]),
                launches=counts)


# ---------------------------------------------------------------------------
# the v2 label model, training options, the quality evaluation
# ---------------------------------------------------------------------------

def write_v2_fixture(torch):
    """The v2 model at full width under build/chip_smoke/v2: the v1
    fixture's speech encoder, a decoder whose style input is the one-hot of
    V2_LABELS (random PyTorch-default weights from the seed), no style
    encoder; the fixture's statistics, and requests of the three clips, each
    with a label and the style BVH as first pose."""
    from zeggs_tpu_torch.config import Options
    from zeggs_tpu_torch.io import checkpoint, weights
    from zeggs_tpu_torch.models.decoder import Decoder

    data, models = V2 / "processed", V2 / "models"
    for d in (data, models):
        d.mkdir(parents=True)
    definition = json.loads((WORK / "processed" / "data_definition.json").read_text())
    (data / "data_definition.json").write_text(json.dumps({**definition,
                                                           "label_names": V2_LABELS}))
    shutil.copy(ROOT / "configs" / "data_pipeline_conf_v2.json", data / "data_pipeline_conf.json")
    shutil.copy(WORK / "processed" / "stats.npz", data / "stats.npz")
    shutil.copy(WORK / "models" / "speech_encoder.npz", models / "speech_encoder.npz")
    v2 = json.loads((ROOT / "configs" / "configs_v2.json").read_text())
    net = Options.from_options_dict(v2).net
    with np.load(data / "stats.npz") as stats:
        pose_in, pose_out = stats["anim_input_mean"].size, stats["anim_output_mean"].size
    torch.manual_seed(SEED + 2)
    dec = Decoder(pose_in, pose_out, net.speech_encoder.speech_encoding_size, len(V2_LABELS),
                  net.decoder.nhidden, net.decoder.num_rnn_layers, net.decoder.rnn_cond)
    checkpoint.save(models / "decoder.npz", weights.to_jax(dec))
    v2["paths"] = {"base_path": str(V2), "path_processed_data": "processed",
                   "output_dir": str(V2), "models_dir": str(models)}
    (V2 / "options.json").write_text(json.dumps(v2, indent=2))
    with open(V2 / "requests.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["base_path", "audio", "style", "file_name", "temperature", "seed",
                    "use_gpu", "frames", "first_pose", "generate"])
        for i, (clip, label) in enumerate(zip(CLIPS, V2_STYLES)):
            w.writerow([str(WORK), f"{clip}.wav", label, clip, "1.0", str(SEED + i), "TRUE", "",
                        "style.bvh", "TRUE"])


def v2_labels(torch, card, results):
    """Phase v2_labels, inference: the v2 model through the generate CLI
    (CSV at bf16 weights, `-b`, `--int8`; `-se label`), the 4 s request on
    the card against the CPU, a 10 s streaming session with a label style
    and one /synthesize with `style_label` on the daemon (an unknown label
    is refused with 400)."""
    from zeggs_tpu_torch.config import Options
    from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
    from zeggs_tpu_torch.io import bvh
    from zeggs_tpu_torch.serve import GestureServer

    write_v2_fixture(torch)
    n, flags, out = len(CLIPS), ["-se", "label"], results / "v2"
    counts = {
        "csv": run_cli_path(torch, out / "csv", "v2 labels (CSV, bf16)", flags,
                            {"decoder_rollout": n, "mel_spectrogram": n}, V2),
        "batched": run_cli_path(
            torch, out / "batched", "v2 labels (-b, bf16)", ["-b", *flags],
            {"decoder_rollout": 1, "gru_cell": B_CHUNK_GRU, "mel_spectrogram": n}, V2),
        "int8": run_cli_path(torch, out / "int8", "v2 labels (--int8)", ["--int8", *flags],
                             {"decoder_rollout": n, "mel_spectrogram": n}, V2),
    }
    opts = Options.from_options_json(V2 / "options.json")

    def pipeline(device, **kw):
        return GesturePipeline(V2 / "models", V2 / "processed", options=opts,
                               style_encoding_type="label", device=device, **kw)

    # the 4 s request on the card (fp32 rollout weights: bounded; bf16:
    # reported) against the CPU; labels draw nothing
    maes = {}
    for tag, device, weights in (("cpu", "cpu", None), ("float32", "cuda", "float32"),
                                 ("bfloat16", "cuda", "bfloat16")):
        pipe = pipeline(device, rollout_weights=weights)
        reset_counts()
        generate_gesture(WORK / "clip_04s.wav", [V2_STYLES[0]], None, None, out / "card_vs_cpu",
                         style_encoding_type="label", first_pose=WORK / "style.bvh",
                         file_name=tag, seed=SEED, pipeline=pipe)
        counts[f"card_vs_cpu_{tag}"] = read_counts()
        if tag != "cpu":
            maes[tag] = float(bvh_mae(torch, out / "card_vs_cpu" / "cpu.bvh",
                                      out / "card_vs_cpu" / f"{tag}.bvh"))
    print(f"v2 labels: 4 s request ({V2_STYLES[0]}, first pose) on the card against the CPU: BVH "
          f"MAE {maes['float32']:.3e} at fp32 rollout weights (tol {CARD_VS_CPU_MAE:g}), "
          f"{maes['bfloat16']:.3e} at bf16 (reported); launches {counts['card_vs_cpu_float32']}")
    if not maes["float32"] < CARD_VS_CPU_MAE or any(counts["card_vs_cpu_cpu"].values()):
        fail(f"v2 labels: card against CPU MAE {maes}, launches {counts}")

    pipe = pipeline("cuda")
    reset_counts()
    sess, times = run_session(torch, pipe, read_wav("clip_10s"), styles=[V2_STYLES[1]],
                              first_pose=WORK / "style.bvh")
    counts["streaming"] = read_counts()
    made = len(pipe.programs.programs())  # the session's, on a new pipeline
    path = sess.write_bvh(out, "stream")
    finite = bool(np.isfinite(bvh.load(path)["rotations"]).all())
    print(f"v2 labels: streaming session ({V2_STYLES[1]}), 10 s clip in 0.5 s pushes, quantum 16: "
          f"{sess.frames_emitted} frames, {sess.decoder_steps} decoder steps, launches "
          f"{counts['streaming']}, finite {finite}; time to first frame "
          f"{times['ttff_s'] * 1e3:.1f} ms, push p50 {times['push_p50_s'] * 1e3:.1f} ms, realtime "
          f"factor {times['rtf']:.2f}, {card}")
    c = counts["streaming"]
    if not (sess.frames_emitted == round(60 * CLIPS["clip_10s"]) and finite
            and c["gru_cell"] == sess.decoder_steps + made == SESSION_STEPS + 1
            and c["decoder_rollout"] == 0 and c["mel_spectrogram"] > 0):
        fail(f"v2 labels streaming: {sess.frames_emitted} frames, launches {c}")

    srv = GestureServer(pipe, max_batch=8, max_wait_ms=50)
    port = srv.start()
    try:
        payload = {"audio_wav_b64": base64.b64encode((WORK / "clip_04s.wav").read_bytes()).decode(),
                   "first_pose_bvh_b64": base64.b64encode((WORK / "style.bvh").read_bytes()).decode(),
                   "seed": SEED}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/synthesize",
            data=json.dumps({**payload, "style_label": "NoSuchStyle"}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=600)
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
        reset_counts()
        t0 = time.perf_counter()
        reply = post(port, "/synthesize", {**payload, "style_label": V2_STYLES[2]})
        serve_ms = (time.perf_counter() - t0) * 1e3
        counts["serve"] = read_counts()
    finally:
        srv.stop()
    (out / "serve.bvh").write_text(reply["bvh"])
    anim = bvh.load(out / "serve.bvh")
    frames = anim["rotations"].shape[0]
    print(f"v2 labels: daemon /synthesize with style_label {V2_STYLES[2]!r}: {frames} frames, "
          f"batch size {reply['batch_size']}, launches {counts['serve']}, {serve_ms:.1f} ms "
          f"(client); an unknown label: HTTP {refused}, {card}")
    if not (refused == 400 and frames == round(60 * CLIPS["clip_04s"])
            and np.isfinite(anim["rotations"]).all()
            and counts["serve"] == launch_counts(decoder_rollout=1, mel_spectrogram=1)):
        fail(f"v2 labels daemon: refused {refused}, {frames} frames, launches {counts['serve']}")
    return dict(launches=counts, card_vs_cpu_mae=maes, stream=times, serve_ms=serve_ms)


def v2_training(torch, card, train_root):
    """Phase v2_labels, training: the training corpus through `cli.pipeline`
    under data_pipeline_conf_v2.json (info_Short.csv, processed_v2), then
    `cli.train` with the v2 options for V2_TRAIN_STEPS steps at B=32, window
    256: a checkpoint and sample synthesis with one-hot styles at iteration
    0 (one GRU-cell launch a decoder step)."""
    from zeggs_tpu_torch.cli import pipeline as cli_pipeline
    from zeggs_tpu_torch.cli import train as cli_train
    from zeggs_tpu_torch.io import bvh, checkpoint

    shutil.copy(train_root / "info.csv", train_root / "info_Short.csv")
    conf = json.loads((ROOT / "configs" / "data_pipeline_conf_v2.json").read_text())
    conf.update(base_path=str(train_root), save_trimmed_audio=False,
                save_trimmed_animation=False)
    (train_root / "pipeline_v2.json").write_text(json.dumps(conf, indent=2))
    reset_counts()
    t0 = time.perf_counter()
    cli_pipeline.main(["-c", str(train_root / "pipeline_v2.json"), "--device", "cuda"])
    torch.cuda.synchronize()
    pipe_s, pipe_counts = time.perf_counter() - t0, read_counts()
    processed = train_root / conf["processed_data_path"]
    labels = json.loads((processed / "data_definition.json").read_text())["label_names"]
    print(f"v2 pipeline ({conf['info_filename']} -> {conf['processed_data_path']}): labels "
          f"{labels}, launches {pipe_counts}, {pipe_s:.3f} s wall, {card}")
    if len(labels) < 3 or pipe_counts != launch_counts(mel_spectrogram=TRAIN_CLIPS * 2):
        fail(f"v2 pipeline: labels {labels}, launches {pipe_counts}")

    v2 = json.loads((ROOT / "configs" / "configs_v2.json").read_text())
    v2["paths"] = {"base_path": str(train_root), "path_processed_data": conf["processed_data_path"],
                   "output_dir": str(train_root / "v2_run"), "models_dir": None}
    v2["train_opt"].update(generate_samples_step=1000, use_tensorboard=False)
    (train_root / "options_v2.json").write_text(json.dumps(v2, indent=2))
    base = cli_train.Trainer
    cli_train.Trainer = Short = short_trainer(torch, base)
    try:
        trainer = cli_train.main(["-o", str(train_root / "options_v2.json"), "--device", "cuda",
                                  "--max-iterations", str(V2_TRAIN_STEPS)])
    finally:
        cli_train.Trainer = base
    rec, graph = Short.record, graph_stats(trainer.program)
    _, _, meta = checkpoint.load_train_state(train_root / "v2_run" / "saved_models")
    saved = sorted(p.stem for p in (train_root / "v2_run" / "saved_models").glob("*.npz"))
    style_in = trainer.nets["decoder"].cell_state_encoder.l0.in_features - trainer.ds.get_shapes()[
        "pose_input_size"]
    samples = sorted((train_root / "v2_run" / "logs" / "samples").glob("*.bvh"))
    finite = all(np.isfinite(bvh.load(f)["rotations"]).all() for f in samples)
    synth = rec["synthesis"] or {}
    print(f"v2 train: {V2_TRAIN_STEPS} steps at v1 width, label styles ({len(labels)} labels, "
          f"the decoder's style input {style_in} wide, no style encoder), B="
          f"{trainer.opts.train.batchsize}, window {trainer.opts.train.window}: losses "
          f"{[round(x, 4) for x in rec['losses']]}; checkpoint {saved} at step {meta['step']}; "
          f"sample synthesis {synth.get('steps')} decoder steps, {synth.get('gru_cell')} GRU-cell "
          f"launches ({synth.get('programs')} captures), {len(samples)} BVHs finite {finite}; "
          f"time step {', '.join(f'{m:.1f}' for m in rec['steps_ms'])} ms (eager warm-up, "
          f"capture and replay, replay); capture {graph['capture_s']:.3f} s, {graph['kernels']} "
          f"kernels, graph pool {graph['graph_mib']:.1f} MiB, {card}")
    if not (trainer.iteration == V2_TRAIN_STEPS and all(rec["finite"])
            and len(rec["steps_ms"]) == V2_TRAIN_STEPS and style_in == len(labels)
            and "style_encoder" not in trainer.nets and meta["step"] == V2_TRAIN_STEPS
            and saved == ["decoder", "opt_state", "speech_encoder"] and samples and finite
            and synth_counted(synth) and graph["graphs"] == 1):
        fail(f"v2 train: {rec}, saved {saved}, style input {style_in}, {graph}")
    del trainer
    return dict(labels=labels, pipeline_mel=pipe_counts["mel_spectrogram"], pipeline_s=pipe_s,
                losses=rec["losses"], steps_ms=rec["steps_ms"], synthesis=synth, graph=graph)


def corpus_batch(torch, opts, processed, device, rows=None, frames=None):
    """A batch of the training corpus at the options' window (the first
    ``rows`` rows and ``frames`` frames), the examples at their longest."""
    from zeggs_tpu_torch.data.dataset import WindowedDataset

    ds = WindowedDataset(processed / "data_definition.json", processed / "processed_data.npz",
                         opts.train.window, example_length=opts.net.style_encoder.example_length)
    idx = np.random.default_rng(SEED).permutation(len(ds))[: rows or opts.train.batchsize]
    batch = ds.make_batch(idx, example_window_length=ds.max_example_length)
    if frames is not None:
        batch = {k: v[:, :frames] if k not in ("example", "example_lengths") else v
                 for k, v in batch.items()}
    return ds, {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def step_gradients(torch, opts, ds, batch, device, deterministic):
    """(loss, {parameter: gradient}, generator state) of one step of the
    training loss from the seed's initial networks on ``device``."""
    from zeggs_tpu_torch.train import loop

    nets = loop.init_networks(opts, ds.get_shapes(), ds.nlabels, SEED, device)
    generator = torch.Generator(device=device).manual_seed(SEED)
    loss, _ = loop.make_loss_fn(opts, ds.stats, ds.parents, ds.dt, deterministic)(
        nets, batch, 7500, generator)
    loss.backward()
    grads = {k: p.grad.detach() for k, p in loop.named_parameters(nets).items()}
    return loss.item(), grads, generator.get_state()


def scaled_error(grads, ref):
    """(worst per-leaf max|diff| / max(1, max|ref|), its leaf)."""
    return max(((grads[k].cpu() - g.cpu()).abs().max().item()
                / max(1.0, g.abs().max().item()), k) for k, g in ref.items())


def option_gradients(torch, train_root):
    """remat and bfloat16 steps on the card: remat's gradients against the
    step without it (v1 width, B=32, window 256, dropout and VAE noise from
    one seeded generator, whose state must end the same); a bfloat16 step
    against the float32 step (whole batch and window) and, over one decoder
    step, against the CPU's bfloat16 step."""
    from zeggs_tpu_torch.config import Options

    opts = Options.from_options_json(train_root / "options.json")
    processed = train_root / "processed"

    def with_train(**kw):
        return dataclasses.replace(opts, train=dataclasses.replace(opts.train, **kw))

    ds, batch = corpus_batch(torch, opts, processed, "cuda")
    loss, grads, state = step_gradients(torch, opts, ds, batch, "cuda", False)
    loss_r, grads_r, state_r = step_gradients(torch, with_train(remat=True), ds, batch, "cuda",
                                              False)
    excess = max(((grads_r[k] - g).abs() - (REMAT_ATOL + REMAT_RTOL * g.abs())).max().item()
                 for k, g in grads.items())
    remat = dict(loss=loss, loss_remat=loss_r, worst_excess=excess,
                 worst_scaled=scaled_error(grads_r, grads)[0],
                 generator_state_equal=bool(torch.equal(state, state_r)))
    print(f"train option remat: one step (B={opts.train.batchsize}, window {opts.train.window}) "
          f"against no remat on the card: loss {loss_r:.6f} / {loss:.6f}, worst element excess "
          f"over atol {REMAT_ATOL:g} + rtol {REMAT_RTOL:g} * |g|: {excess:.3e} (must be <= 0), "
          f"worst max|diff| / max(1, max|g|) {remat['worst_scaled']:.3e}; generator state equal "
          f"{remat['generator_state_equal']}")
    if not (excess <= 0 and remat["generator_state_equal"]
            and abs(loss_r - loss) <= REMAT_RTOL * abs(loss)):
        fail(f"remat gradients differ from the step without it: {remat}")

    bf16 = with_train(compute_dtype="bfloat16")
    one = {}
    for tag, o, device in (("card_bf16", bf16, "cuda"), ("cpu_bf16", bf16, "cpu"),
                           ("card_f32", opts, "cuda")):
        ds, b = corpus_batch(torch, o, processed, device, rows=BF16_BATCH, frames=2)
        one[tag] = step_gradients(torch, o, ds, b, device, True)
    err, leaf = scaled_error(one["card_bf16"][1], one["cpu_bf16"][1])
    vs_f32 = scaled_error(one["card_bf16"][1], one["card_f32"][1])
    loss_err = abs(one["card_bf16"][0] - one["cpu_bf16"][0]) / abs(one["cpu_bf16"][0])
    full = step_gradients(torch, bf16, *corpus_batch(torch, bf16, processed, "cuda"), "cuda", True)
    full_f32 = step_gradients(torch, opts, *corpus_batch(torch, opts, processed, "cuda"), "cuda",
                              True)
    report = dict(card_vs_cpu=err, leaf=leaf, loss_rel_err=loss_err, vs_f32=vs_f32[0],
                  full_vs_f32=scaled_error(full[1], full_f32[1])[0],
                  losses=dict(bf16=one["card_bf16"][0], f32=one["card_f32"][0]))
    print(f"train option bfloat16: a whole step (B={opts.train.batchsize}, window "
          f"{opts.train.window}) against the float32 step on the card: gradients "
          f"{report['full_vs_f32']:.3e} of max(1, max|g|) (tol {BF16_GRAD_TOL:g}), losses "
          f"{full[0]:.6f} / {full_f32[0]:.6f}; one decoder step ({BF16_BATCH} rows, 2 frames), "
          f"the card against the CPU, both bfloat16: loss relative error {loss_err:.3e} (tol "
          f"{BF16_LOSS_RTOL:g}), gradients {err:.3e} at {leaf} (tol {BF16_GRAD_TOL:g}); against "
          f"float32 on the card (reported) {vs_f32[0]:.3e} at {vs_f32[1]}")
    if not (err <= BF16_GRAD_TOL and loss_err <= BF16_LOSS_RTOL
            and report["full_vs_f32"] <= BF16_GRAD_TOL and full[0] != full_f32[0]
            and one["card_bf16"][0] != one["card_f32"][0]):
        fail(f"bfloat16 step on the card: {report}")
    return dict(remat=remat, bfloat16=report)


def train_options(torch, card, train_root):
    """Phase train_options: `cli.train` at v1 width, B=32, for OPTION_STEPS
    steps under each of TRAIN_OPTIONS (finite losses; the option in effect;
    sample synthesis at iteration 0, one GRU-cell launch a decoder step but
    none for FiLM, whose rollout is eager), then `option_gradients`."""
    from zeggs_tpu_torch.cli import train as cli_train

    v1 = json.loads((train_root / "options.json").read_text())
    base, report = cli_train.Trainer, {}
    try:
        for name, (train_opt, net_opt, flags) in TRAIN_OPTIONS.items():
            o = json.loads(json.dumps(v1))
            o["train_opt"].update(train_opt)
            for block, values in net_opt.items():
                o["net_opt"][block].update(values)
            o["paths"]["output_dir"] = str(train_root / f"option_{name}")
            path = train_root / f"option_{name}.json"
            path.write_text(json.dumps(o, indent=2))
            cli_train.Trainer = Short = short_trainer(torch, base)
            t0 = time.perf_counter()
            trainer = cli_train.main(["-o", str(path), "--device", "cuda", "--max-iterations",
                                      str(OPTION_STEPS), *flags])
            wall = time.perf_counter() - t0
            rec, synth = Short.record, Short.record["synthesis"] or {}
            t, net = trainer.opts.train, trainer.opts.net
            in_effect = trainer.iteration == OPTION_STEPS and {
                "none": True, "bfloat16": t.compute_dtype == "bfloat16", "remat": t.remat,
                "gru_style_body": net.style_encoder.type == "gru",
                "film": trainer.nets["decoder"].rnn_cond == "film",
                "host_batches": trainer.device_corpus is None}[name]
            film = name == "film"
            graph = graph_stats(trainer.program)
            del trainer
            print(f"time train option {name}: {OPTION_STEPS} steps at v1 width, B={t.batchsize}, "
                  f"window {t.window}: {', '.join(f'{m:.1f}' for m in rec['steps_ms'])} ms "
                  f"(the eager warm-up, then the capture and its replay), losses "
                  f"{[round(x, 4) for x in rec['losses']]}, all finite {all(rec['finite'])}; "
                  f"capture {graph['capture_s']:.3f} s, {graph['kernels']} kernels of "
                  f"{graph['nodes']} nodes, graph pool {graph['graph_mib']:.1f} MiB; sample "
                  f"synthesis {synth.get('steps')} decoder steps, {synth.get('gru_cell')} GRU-cell "
                  f"launches ({synth.get('programs')} captures); run {wall:.1f} s with set-up, "
                  f"{card}")
            if not (in_effect and all(rec["finite"]) and len(rec["steps_ms"]) == OPTION_STEPS
                    and synth_counted(synth, film) and graph["graphs"] == 1):
                fail(f"train option {name}: in effect {in_effect}, {rec}, {graph}")
            report[name] = dict(steps_ms=rec["steps_ms"], losses=rec["losses"], synthesis=synth,
                                wall_s=wall, graph=graph)
    finally:
        cli_train.Trainer = base
    report["gradients"] = option_gradients(torch, train_root)
    return report


def eval_bounds(ds, card, cpu):
    """Per validation clip, from the two evaluations' rollouts: (largest lpos
    difference d after the warm-in, the jerk-ratio bound 8 * 60^3 * sqrt(3)
    * d over the ground truth's mean jerk, the variance-ratio bound: the
    largest (2 std d + d^2) of a moving joint over its ground-truth
    variance); the derivation of tests/test_torch_quality.py."""
    fps, out = 1.0 / ds.dt, []
    for ri, ((_, p), (_, q)) in enumerate(zip(card, cpu, strict=True)):
        g = ds.get_sample("valid", range_index=ri)[0]["lpos"][0]
        warm = min(int(round(0.5 * fps)), max(0, len(p) - 5))
        p, q, g = p[warm:], q[warm:], g[warm:]
        diff = np.abs(p - q)
        g_jerk = np.linalg.norm(np.diff(g, n=3, axis=0) * fps**3, axis=-1).mean()
        std, d_j = np.maximum(p.std(axis=0), q.std(axis=0)), diff.max(axis=0)
        g_var = g.var(axis=0).mean(-1)
        moving = g_var > 1e-6
        out.append((float(diff.max()), float(8 * fps**3 * np.sqrt(3) * diff.max() / g_jerk),
                    float(((2 * std * d_j + d_j**2).mean(-1)[moving] / g_var[moving]).max())))
    return out


def reports_agree(a, b, bounds):
    """The failed comparisons of two evaluation reports (empty: they agree)."""
    bad = []

    def close(x, y, quantum, key):
        if not abs(x - y) <= quantum + EVAL_RTOL * abs(y):
            bad.append((key, x, y))

    for i, (ca, cb, (_, jerk, var)) in enumerate(zip(a["clips"], b["clips"], bounds, strict=True)):
        bad += [(k, ca[k], cb[k]) for k in ("label", "frames", "warmin_frames_skipped")
                if ca[k] != cb[k]]
        for k in ("lpos_mae", "root_pos_mae"):
            close(ca[k], cb[k], 1e-5, f"clip {i} {k}")
        close(ca["vel_ratio"], cb["vel_ratio"], 1e-4, f"clip {i} vel_ratio")
        if not abs(ca["jerk_ratio"] - cb["jerk_ratio"]) <= jerk + 1e-4:
            bad.append((f"clip {i} jerk_ratio", ca["jerk_ratio"], cb["jerk_ratio"]))
        if not abs(ca["motion_var_ratio_median"] - cb["motion_var_ratio_median"]) <= var + 1e-4:
            bad.append((f"clip {i} motion_var_ratio_median", ca["motion_var_ratio_median"],
                        cb["motion_var_ratio_median"]))
    bad += [(k, a[k], b[k]) for k in ("n_valid_clips", "total_frames") if a[k] != b[k]]
    close(a["lpos_mae_mean"], b["lpos_mae_mean"], 2e-5, "lpos_mae_mean")
    close(a["vel_ratio_mean"], b["vel_ratio_mean"], 2e-4, "vel_ratio_mean")
    if not abs(a["jerk_ratio_mean"] - b["jerk_ratio_mean"]) <= np.mean(
            [x[1] for x in bounds]) + 2e-4:
        bad.append(("jerk_ratio_mean", a["jerk_ratio_mean"], b["jerk_ratio_mean"]))
    if not abs(a["motion_var_ratio_median"] - b["motion_var_ratio_median"]) <= max(
            x[2] for x in bounds) + 2e-4:
        bad.append(("motion_var_ratio_median", a["motion_var_ratio_median"],
                    b["motion_var_ratio_median"]))
    return bad


def quality(torch, card, train_root):
    """Phase quality: `cli.eval_checkpoint.evaluate` on the training phase's
    checkpoint (iteration TRAIN_STEPS) on the card and on the CPU: the
    reports agree, the gate verdicts are equal (not their value: 6 steps do
    not train a model), and the card's rollouts replay the rollout
    programs, one GRU-cell launch a decoder step of the validation
    rollouts and one a program's capture; on the card in turns through the
    programs and through the eager rollout (`EagerRollouts`), whose report
    must be the same; the v2 run's checkpoint is refused (label styles, no
    style encoder)."""
    from zeggs_tpu_torch.cli import eval_checkpoint as E
    from zeggs_tpu_torch.data.dataset import WindowedDataset
    from zeggs_tpu_torch.infer.programs import ProgramCache

    def run_root(name, processed, models):
        root = WORK / name
        root.mkdir()
        (root / "processed").symlink_to(processed)
        (root / "models").symlink_to(models)
        return root

    root = run_root("eval", train_root / "processed", train_root / "run" / "saved_models")
    rollouts, reports, seconds, counts = {}, {}, {}, {}
    original = ProgramCache.rollout

    def recording(self, *args, **kw):
        out = original(self, *args, **kw)  # root_pos, root_rot, lpos, ltxy
        rollouts[run].append(tuple(out[i][0].float().cpu().numpy() for i in (0, 2)))
        return out

    class RecordedEager(EagerRollouts):
        def rollout(self, *args, **kw):
            out = super().rollout(*args, **kw)
            rollouts[run].append(tuple(out[i][0].float().cpu().numpy() for i in (0, 2)))
            return out

    ProgramCache.rollout = recording
    try:
        for run, device in (("cuda", "cuda"), ("cpu", "cpu"), ("cuda_eager", "cuda"),
                            ("cuda_again", "cuda")):
            rollouts[run] = []
            E.ProgramCache = RecordedEager if run == "cuda_eager" else ProgramCache
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reports[run] = E.evaluate(root, TRAIN_STEPS, device=device)
            torch.cuda.synchronize()
            seconds[run], counts[run] = time.perf_counter() - t0, read_counts()
    finally:
        ProgramCache.rollout, E.ProgramCache = original, ProgramCache
    a, b = reports["cuda"], reports["cpu"]
    ds = WindowedDataset(root / "processed" / "data_definition.json",
                         root / "processed" / "processed_data.npz", 256)
    bounds = eval_bounds(ds, rollouts["cuda"], rollouts["cpu"])
    bad = reports_agree(a, b, bounds)
    lengths = [len(r[0]) - 1 for r in rollouts["cuda"]]
    steps, programs = sum(lengths), ladder_programs(lengths)
    graphed_vs_eager = max(float(np.abs(x - y).max()) for r, q in zip(
        rollouts["cuda"], rollouts["cuda_eager"], strict=True) for x, y in zip(r, q))
    gates = (E.gate(a), E.gate(b))
    keys = ("lpos_mae_mean", "vel_ratio_mean", "jerk_ratio_mean", "motion_var_ratio_median")
    print(f"quality: eval_checkpoint at iteration {TRAIN_STEPS}, {a['n_valid_clips']} validation "
          f"clips, {a['total_frames']} frames; card {[a[k] for k in keys]}, CPU "
          f"{[b[k] for k in keys]} ({', '.join(keys)}); largest lpos difference "
          f"{max(x[0] for x in bounds):.3e}, derived bounds jerk {[round(x[1], 5) for x in bounds]}, "
          f"variance {[x[2] for x in bounds]}; gate {gates}; launches {counts['cuda']} for {steps} "
          f"decoder steps and {programs} program captures (CPU {counts['cpu']}; eager on the card "
          f"{counts['cuda_eager']}); on the card the programs' rollouts against the eager "
          f"ones max|diff| {graphed_vs_eager:.3e} (bound {GRAPH_MAE:g}), reports equal "
          f"{reports['cuda_eager'] == a == reports['cuda_again']}")
    print(f"time quality: evaluate on the card through the programs {seconds['cuda']:.3f}, "
          f"{seconds['cuda_again']:.3f} s, eager {seconds['cuda_eager']:.3f} s, on the CPU "
          f"{seconds['cpu']:.3f} s, {card}")
    if bad or gates[0] != gates[1]:
        fail(f"quality: the card's report differs from the CPU's: {bad}, gates {gates}")
    expected = launch_counts(gru_cell=steps + programs)
    if (counts["cuda"] != expected or counts["cuda_again"] != expected or any(
            counts["cpu"].values()) or counts["cuda_eager"]["gru_cell"] != steps
            or graphed_vs_eager > GRAPH_MAE or reports["cuda_again"] != a):
        fail(f"quality: launches {counts} for {steps} decoder steps and {programs} programs, "
             f"graphed against eager {graphed_vs_eager}")
    label_root = run_root("eval_v2", train_root / "processed_v2",
                          train_root / "v2_run" / "saved_models")
    try:
        E.evaluate(label_root, V2_TRAIN_STEPS, device="cuda")
        fail("quality: the label-style checkpoint was evaluated")
    except ValueError as e:
        print(f"quality: the v2 (label-style) checkpoint is refused: {e}")
    return dict(report={k: a[k] for k in keys}, report_cpu={k: b[k] for k in keys},
                gate=gates[0], launches=counts["cuda"], decoder_steps=steps, programs=programs,
                graphed_vs_eager=graphed_vs_eager,
                max_lpos_diff=max(x[0] for x in bounds), seconds=seconds)


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

    phase_s, mark = {}, [t0]

    def done(phase):  # seconds since the last phase ended
        now = time.perf_counter()
        phase_s[phase], mark[0] = now - mark[0], now

    done("build")
    results = write_fixture(torch)
    with torch.inference_mode():
        report = check_kernels(torch, card)
        floor = barrier_floor(torch, card, report["bfloat16"]["T1"])
        gru = check_gru_cell(torch, card)
        mel = check_mel(torch, card)
        bptt = check_decoder_train(torch, card)
    done("fixture_and_kernels")
    n = len(CLIPS)
    csv_counts = run_cli_path(torch, results, "main path (CSV, bf16)", [],
                              {"decoder_rollout": n, "mel_spectrogram": n})
    batch_counts = run_cli_path(
        torch, results / "batched", "batched path (-b, bf16)", ["-b"],
        {"decoder_rollout": 1, "gru_cell": B_CHUNK_GRU, "mel_spectrogram": n})
    batched_vs_single(torch, results)
    int8_counts = run_cli_path(torch, results / "int8", "int8 path (--int8)", ["--int8"],
                               {"decoder_rollout": n, "mel_spectrogram": n})
    done("cli_paths")
    time_requests(torch, card, results)
    time_batch(torch, card, results)
    card_vs_cpu(torch)
    done("timings_and_card_vs_cpu")
    stream = streaming(torch, card, results)
    done("streaming")
    served = serve(torch, card)
    done("serve")
    meshed = mesh_phase(torch, card, results)
    done("mesh")
    progs = programs_phase(torch, card, results)
    done("programs")
    stage = output_stage_phase(torch, card, results)
    done("output_stage")
    reference = reference_checkpoints(torch, card)
    with torch.inference_mode():
        gl = griffin_lim_phase(torch, card)
    done("reference_checkpoints_and_griffin_lim")
    grad_err = grad_card_vs_cpu(torch)
    trained = train_phase(torch, card)
    done("train")
    ddp = ddp_phase(torch, card, WORK / "train")
    done("ddp")
    v2 = v2_labels(torch, card, results)
    v2.update(training=v2_training(torch, card, WORK / "train"))
    done("v2_labels")
    options = train_options(torch, card, WORK / "train")
    done("train_options")
    judged = quality(torch, card, WORK / "train")
    done("quality")
    recipe = recipe_phase(torch, card)
    done("recipe")
    bench = bench_phase(torch, card)
    done("bench")
    left = programs_left(torch, card, bench)
    done("programs_left")
    progs["failed_capture"] = failed_capture_raises(torch)
    done("failed_capture")
    print(json.dumps({"phase_seconds": phase_s, "total_s": sum(phase_s.values())}))
    if "jax" in sys.modules:
        fail("jax was imported")

    v2l = v2["launches"]

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
                                   "serve": served,
                                   "mesh": {k: meshed[k]["launches"] for k in
                                            ("batch64_one", "batch64_mesh", "batched", "serve")},
                                   "pipeline": {"mel_spectrogram": trained["pipeline_mel"]},
                                   "train_step": trained["launches_per_step"],
                                   "sample_synthesis": {"gru_cell": trained["synthesis_gru"]},
                                   "reference_checkpoints": reference["launches"],
                                   "output_stage": {
                                       "batch64": stage["runs"]["batch64_float16"]["launches"],
                                       "csv3": stage["runs"]["csv3_float16_depth2"]["launches"],
                                       "daemon": stage["daemon"]["launches"]},
                                   "recipe": {"corpus": recipe["corpus"]["launches"],
                                              "eval": recipe["eval"]["launches"]},
                                   "griffin_lim": gl["launches"],
                                   "bench": bench["launches"],
                                   "programs_left": {k: v["launches"] for k, v in left.items()
                                                     if isinstance(v, dict)},
                                   "ddp_sample_synthesis": {
                                       k: v["synthesis"]["gru_cell"] for k, v in ddp.items()
                                       if "synthesis" in v}}}))
    print(json.dumps({"train": {**trained, "grad_card_vs_cpu": grad_err, "card": card}}))
    print(json.dumps({"reference_checkpoints": reference, "griffin_lim": gl, "ddp": ddp,
                      "card": card}))
    print(json.dumps({"v2_labels": v2, "train_options": options, "quality": judged,
                      "card": card}))
    print(json.dumps({"mesh": meshed}))
    print(json.dumps({"programs": progs}))
    print(json.dumps({"output_stage": stage, "recipe": recipe}))
    print(json.dumps({"bench": bench, "card": card}))
    print(json.dumps({"programs_left": left}))
    print(json.dumps({"barrier_floor": {"steps": report["bfloat16"]["T1"], **floor}}))
    print(json.dumps({"kernels": [
        {**decoder_entry("float32", stream["offline_counts"]["decoder_rollout"]),
         "launches_v2_card_vs_cpu": v2l["card_vs_cpu_float32"]["decoder_rollout"]},
        {**decoder_entry("bfloat16", csv_counts["decoder_rollout"]),
         "launches_reference_checkpoints": reference["launches"]["decoder_rollout"],
         "launches_v2_csv": v2l["csv"]["decoder_rollout"],
         "launches_v2_batched": v2l["batched"]["decoder_rollout"],
         "launches_v2_serve": v2l["serve"]["decoder_rollout"],
         "launches_mesh": sum(meshed[k]["launches"]["decoder_rollout"]
                              for k in ("batch64_mesh", "batched", "serve")),
         "launches_output_stage_daemon": stage["daemon"]["launches"]["decoder_rollout"],
         "launches_bench": {k: bench["launches"][k]["decoder_rollout"] for k in ("core", "serve")},
         "launches_fused_b1_profile":
             left["fused_b1_profile"]["fused_bf16_launches"]["decoder_rollout"],
         "launches_quickstart": left["quickstart"]["launches"]["decoder_rollout"]},
        {**decoder_entry("int8", int8_counts["decoder_rollout"]),
         "launches_v2_int8": v2l["int8"]["decoder_rollout"],
         "launches_fused_b1_profile":
             left["fused_b1_profile"]["fused_int8_launches"]["decoder_rollout"]},
        {"name": "gru_cell", "route": "cuda", "source": "zeggs_tpu_torch/csrc/gru_cell.cu",
         "replaces": "zeggs_tpu/ops/pallas/gru_kernel.py:46",
         "launches": batch_counts["gru_cell"], "max_abs_err": gru["err"], "tol": GRU_TOL,
         **{k: gru[64][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "batch": 64, "by_batch": {str(B): gru[B] for B in GRU_TIMED},
         "launches_sample_synthesis": trained["synthesis_gru"],
         "launches_ddp_sample_synthesis": ddp["device_corpus"]["synthesis"]["gru_cell"],
         "launches_v2_batched": v2l["batched"]["gru_cell"],
         "launches_v2_streaming": v2l["streaming"]["gru_cell"],
         "launches_v2_sample_synthesis": v2["training"]["synthesis"]["gru_cell"],
         "launches_train_options_sample_synthesis": {
             k: v["synthesis"]["gru_cell"] for k, v in options.items() if "synthesis" in v},
         "launches_eval": judged["launches"]["gru_cell"],
         "launches_mesh_batch64": meshed["batch64_mesh"]["launches"]["gru_cell"],
         "launches_mesh_batched": meshed["batched"]["launches"]["gru_cell"],
         "launches_mesh_serve": meshed["serve"]["launches"]["gru_cell"],
         "launches_streaming": stream["counts"]["gru_cell"],
         "launches_programs_warmup": progs["warmup"]["launches"]["gru_cell"],
         "launches_programs_batched": progs["batched"]["launches"]["graphed"]["gru_cell"],
         "launches_programs_batch64": progs["batch64"]["launches"]["graphed"]["gru_cell"],
         "launches_programs_session": progs["session"]["launches"]["graphed"]["gru_cell"],
         "launches_programs_serve": progs["serve"]["launches"]["graphed"]["gru_cell"],
         "launches_output_stage_csv": stage["runs"]["csv3_float16_depth2"]["launches"]["gru_cell"],
         "launches_recipe_eval": recipe["eval"]["launches"]["gru_cell"],
         "launches_bench": {k: bench["launches"][k]["gru_cell"]
                            for k in ("core", "serve", "streaming")},
         "launches_fused_b1_profile": left["fused_b1_profile"]["scan_launches"]["gru_cell"],
         "launches_train_curve_sample_synthesis": left["train_curve"]["launches"]["gru_cell"],
         "launches_loss_profile": left["loss_profile"]["launches"]["gru_cell"],
         "launches_quickstart": left["quickstart"]["launches"]["gru_cell"]},
        {"name": "mel_spectrogram", "route": "cuda",
         "source": "zeggs_tpu_torch/csrc/mel_spectrogram.cu",
         "replaces": "zeggs_tpu/ops/pallas/mel_kernel.py:58",
         "launches": csv_counts["mel_spectrogram"],
         "max_abs_err": max(mel["err"], trained["pipeline_mel_err"]), "tol": MEL_TOL,
         **{k: mel[mel["clip_frames"]][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "frames": mel["clip_frames"],
         "by_frames": {str(nf): mel[nf] for nf in (*MEL_TIMED, mel["clip_frames"])},
         "by_groups": mel["by_groups"], "global_variant_ms": mel["global_variant_ms"],
         "n_fft_8192": {k: v for k, v in mel.items() if str(k).startswith("n_fft_8192")},
         "launches_pipeline": trained["pipeline_mel"],
         "launches_reference_checkpoints": reference["launches"]["mel_spectrogram"],
         "launches_griffin_lim_input": gl["launches"]["mel_spectrogram"],
         "launches_v2_csv": v2l["csv"]["mel_spectrogram"],
         "launches_v2_streaming": v2l["streaming"]["mel_spectrogram"],
         "launches_v2_serve": v2l["serve"]["mel_spectrogram"],
         "launches_v2_pipeline": v2["training"]["pipeline_mel"],
         "launches_eval": judged["launches"]["mel_spectrogram"],
         "launches_mesh_batch64": meshed["batch64_mesh"]["launches"]["mel_spectrogram"],
         "launches_output_stage_csv":
             stage["runs"]["csv3_float16_depth2"]["launches"]["mel_spectrogram"],
         "launches_recipe_corpus": recipe["corpus"]["launches"]["mel_spectrogram"],
         "launches_bench": {k: bench["launches"][k]["mel_spectrogram"]
                            for k in ("serve", "streaming")},
         "launches_train_anneal_corpus": left["train_anneal"]["launches"]["mel_spectrogram"],
         "launches_quickstart": left["quickstart"]["launches"]["mel_spectrogram"]},
        {"name": "decoder_train", "route": "cuda",
         "source": "zeggs_tpu_torch/csrc/decoder_train.cu", "replaces": None,
         "launches": trained["launches_per_step"]["decoder_train"],
         "max_abs_err": bptt["err"], "tol": DT_TOL,
         **{k: bptt["frame"][k] for k in ("ms", "plain_ms", "bound_ms")}, "bound_by": "bytes",
         "library_ms": None, "shape": dict(zip(("batch", "hidden", "joints"), DT_SHAPE)),
         "frame": list(DT_FRAME),
         "by_kernel": {k: v for k, v in bptt.items() if k not in ("err", "frame")},
         "launches_bench_train": bench["launches"]["train"]["decoder_train"],
         "launches_train_anneal": left["train_anneal"]["launches"]["decoder_train"],
         "launches_train_curve": left["train_curve"]["launches"]["decoder_train"],
         "launches_grad_profile": left["grad_profile"]["launches"]["decoder_train"],
         "launches_train_step_profile":
             left["train_step_profile"]["launches"]["decoder_train"]},
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        ddp_worker(sys.argv[2:])
    else:
        main()
