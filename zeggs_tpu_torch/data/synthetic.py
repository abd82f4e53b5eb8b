"""The synthetic corpus the recipe's programs and the quickstart train on
(the port's copy of `tests/synthetic.py`'s raw corpus and ``small_options``,
which import ``jax``).

The real ZEGGS dataset is not in the repository, so these programs make a
structurally identical one from seeds: an 8-joint skeleton with the joints
the featurizer resolves by name, smooth motion at 60 fps and a speech-like
tone at 16 kHz, with the info.csv and speaker timing files the corpus
pipeline reads.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from ..config import (DecoderConfig, MelConfig, NetworkConfig, Options, PipelineConfig,
                      SpeechEncoderConfig, StyleEncoderConfig, TrainConfig)
from ..io import bvh, wav
from .pipeline import data_pipeline

BONE_NAMES = ["Hips", "Spine", "Spine1", "Spine2", "Neck", "Head", "RightArm", "LeftArm"]
PARENTS = [-1, 0, 1, 2, 3, 4, 3, 3]
LABELS = ["Neutral", "Happy", "Sad"]


def small_options():
    """Narrow widths for demos and tests: decoder 32, speech 16, style 24
    wide with an 8-wide embedding over 64-frame examples, batch 4 x 32."""
    return Options(
        net=NetworkConfig(
            decoder=DecoderConfig(nhidden=32, num_rnn_layers=2),
            speech_encoder=SpeechEncoderConfig(nhidden=16, speech_encoding_size=16),
            style_encoder=StyleEncoderConfig(nhidden=24, style_encoding_size=8,
                                             example_length=64, type="attn", use_vae=True),
        ),
        train=TrainConfig(batchsize=4, window=32),
    )


def make_motion(nframes=240, seed=0):
    """Smooth random joint rotations and root translation at 60 fps."""
    rng = np.random.default_rng(seed)
    njoints = len(BONE_NAMES)
    t = np.linspace(0, 2 * np.pi, nframes)[:, None, None]
    phase = rng.uniform(0, 2 * np.pi, (1, njoints, 3))
    amp = rng.uniform(5, 25, (1, njoints, 3))
    rotations = amp * np.sin(2 * t + phase)  # degrees
    offsets = rng.uniform(-10, 10, (njoints, 3)).astype(np.float32)
    offsets[0] = 0
    positions = np.repeat(offsets[None], nframes, axis=0).astype(np.float32)
    positions[:, 0, 0] += np.linspace(0, 30, nframes)
    positions[:, 0, 1] += 90.0
    return {
        "rotations": rotations.astype(np.float32),
        "positions": positions,
        "offsets": offsets,
        "parents": np.asarray(PARENTS, np.int32),
        "names": list(BONE_NAMES),
        "order": "zyx",
        "frametime": 1.0 / 60.0,
    }


def make_audio(seconds=2.0, fs=16000, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * fs)) / fs
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    x += 0.05 * rng.normal(size=t.shape)
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def write_raw_corpus(root, n_clips=3, seconds=4.0):
    """The raw corpus the pipeline reads: original/{bvh, wav, speaker timing
    csv} and info.csv with clap-sync timecodes that trim 0.5 s at each end;
    the last clip is validation (a corpus of one clip keeps it in
    training)."""
    root = Path(root)
    orig = root / "original"
    orig.mkdir(parents=True, exist_ok=True)
    fs = 16000
    rows = []
    for i in range(n_clips):
        anim = make_motion(int(seconds * 60), seed=10 + i)
        audio = make_audio(seconds, fs=fs, seed=10 + i)
        name = f"{i:03d}_Synth_{i}"
        bvh.save(orig / f"{name}.bvh", anim)
        wav.write_wavefile(orig / f"{name}.wav", audio, fs)
        with open(orig / f"{name}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["#", "Start", "End"])
            w.writerow(["R1", "0:0.0", f"0:{seconds:.1f}"])
        rows.append(dict(
            audio_filename=f"{name}.wav",
            audio_start_time="00:00:00:00",
            anim_start_time="00:00:00:00",
            acting_start_time="00:00:00:30",
            acting_end_time=f"00:00:{int(seconds) - 1:02d}:30",
            style=LABELS[i % len(LABELS)],
            anim_bvh=f"{name}.bvh",
            validation="TRUE" if (n_clips > 1 and i == n_clips - 1) else "FALSE",
        ))
    with open(root / "info.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    return root


def build_corpus(root, device="cuda"):
    """The recipe's corpus under ``root`` (`scripts/train_anneal.py`'s
    ``build_corpus``): 6 raw clips of 8 s through the pipeline on
    ``device`` -> the processed directory."""
    root = Path(root)
    write_raw_corpus(root, n_clips=6, seconds=8.0)
    data_pipeline(PipelineConfig(
        base_path=str(root), processed_data_path="processed", info_filename="info.csv",
        audio_conf=MelConfig(normalize_loudness=False), len_ratios=(1.0,),
        save_trimmed_audio=False, save_trimmed_animation=False), device=device)
    return root / "processed"
