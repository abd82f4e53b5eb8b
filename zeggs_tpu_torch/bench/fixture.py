"""What every bench stage shares: the model's widths, the synthetic inputs
and serving corpus, the card's description, the kernels' launch counts by
phase, the stages' arguments and the watchdog.

The port's own copies of `__graft_entry__.py`'s constants, `_stats` and
`_initial_state`, and of `scripts/bench_serve.py`'s `_skeleton`, `_motion`
and `build_corpus` (both import ``jax``). The networks come from the port's
`train/loop.py::init_networks` with random weights from a seed and are
written as `.npz` through `io/checkpoint.py`; throughput does not depend on
the weights' values.

``--tiny`` (8 joints, narrow widths) is a rehearsal on the CPU only: a run
on the card is always at the v1 width (75 joints, pose 1134 -> 1131, speech
81 -> 64, ``attn`` style 64, decoder GRU 2 x 1024 ``normal``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from ..config import (DecoderConfig, MelConfig, NetworkConfig, Options, PipelineConfig,
                      SpeechEncoderConfig, StyleEncoderConfig)

# Full ZEGGS dimensions (data/processed_v1): 75 joints, 1134/1131 pose dims,
# 81 audio features, decoder hidden 1024, speech/style encodings 64.
NJOINTS = 75
POSE_IN = 6 + NJOINTS * 15 + 3
POSE_OUT = 6 + NJOINTS * 15
AUDIO_DIM = 81
DT = 1.0 / 60.0
#: joints of the ``--tiny`` rehearsal (the 7 named spine joints and one more)
TINY_JOINTS = 8
#: the repository's root: stages run from it, and their files go under build/
REPO = Path(__file__).resolve().parents[2]
CORPUS_ROOT = REPO / "build" / "bench" / "corpus"


@dataclasses.dataclass(frozen=True)
class Width:
    """The model a run uses: its joints and its options."""

    njoints: int
    options: Options

    @property
    def pose_in(self):
        return 6 + self.njoints * 15 + 3

    @property
    def pose_out(self):
        return 6 + self.njoints * 15

    @property
    def dims(self):
        return dict(num_audio_features=AUDIO_DIM, pose_input_size=self.pose_in,
                    pose_output_size=self.pose_out)


def width(tiny=False, train=None):
    """The v1 width, or the ``--tiny`` rehearsal's: 8 joints, speech 16,
    style 8, decoder 32 wide. ``train``: the options' TrainConfig."""
    if not tiny:
        return Width(NJOINTS, Options() if train is None else Options(train=train))
    net = NetworkConfig(
        decoder=DecoderConfig(nhidden=32),
        speech_encoder=SpeechEncoderConfig(nhidden=16, speech_encoding_size=16),
        style_encoder=StyleEncoderConfig(nhidden=24, style_encoding_size=8, example_length=32))
    return Width(TINY_JOINTS, Options(net=net) if train is None else Options(net=net, train=train))


def _stats(pose_in=POSE_IN, pose_out=POSE_OUT):
    return {
        "audio_input_mean": np.zeros(AUDIO_DIM, np.float32),
        "audio_input_std": np.float32(1.0),
        "anim_input_mean": np.zeros(pose_in, np.float32),
        "anim_input_std": np.ones(pose_in, np.float32),
        "anim_output_mean": np.zeros(pose_out, np.float32),
        "anim_output_std": np.ones(pose_out, np.float32),
    }


def _initial_state(rng, B, njoints):
    """The 8 frame-0 state arrays of B clips (host arrays; the JAX copy
    returns device arrays of the same values)."""
    q = rng.normal(size=(B, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return (
        rng.normal(size=(B, 3)).astype(np.float32),
        q,
        rng.normal(size=(B, 3)).astype(np.float32) * 0.1,
        rng.normal(size=(B, 3)).astype(np.float32) * 0.1,
        rng.normal(size=(B, njoints, 3)).astype(np.float32),
        rng.normal(size=(B, njoints, 2, 3)).astype(np.float32),
        rng.normal(size=(B, njoints, 3)).astype(np.float32) * 0.1,
        rng.normal(size=(B, njoints, 3)).astype(np.float32) * 0.1,
    )


# ---------------------------------------------------------------------------
# the serving corpus (scripts/bench_serve.py)
# ---------------------------------------------------------------------------

def _skeleton(njoints=NJOINTS):
    """A skeleton with the names the featurizer resolves."""
    names = ["Hips", "Spine", "Spine1", "Spine2", "Spine3", "Neck", "Head"]
    parents = [-1, 0, 1, 2, 3, 4, 5]
    while len(names) < njoints:
        i = len(names)
        names.append(f"Joint{i}")
        parents.append((i - 1) % 7)  # bushy tree off the spine chain
    return names, parents


def _motion(nframes, seed, njoints=NJOINTS):
    rng = np.random.default_rng(seed)
    names, parents = _skeleton(njoints)
    t = np.linspace(0, 2 * np.pi, nframes)[:, None, None]
    phase = rng.uniform(0, 2 * np.pi, (1, njoints, 3))
    amp = rng.uniform(3, 20, (1, njoints, 3))
    rotations = (amp * np.sin(2 * t + phase)).astype(np.float32)
    offsets = rng.uniform(-8, 8, (njoints, 3)).astype(np.float32)
    offsets[0] = 0
    positions = np.repeat(offsets[None], nframes, axis=0).astype(np.float32)
    positions[:, 0, 1] += 95.0
    positions[:, 0, 0] += np.linspace(0, 20, nframes)
    return {
        "rotations": rotations, "positions": positions, "offsets": offsets,
        "parents": np.asarray(parents, np.int32), "names": names,
        "order": "zyx", "frametime": 1.0 / 60.0,
    }


def speech_like(rng, n, fs=16000):
    """n samples of a 220 Hz tone under a 3 Hz envelope, with noise."""
    t = np.arange(n) / fs
    return (0.3 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
            + 0.05 * rng.normal(size=n)).astype(np.float32)


def _requests(clips_dir, style_paths, n_requests, seed):
    """The requests' WAVs (written) and their list: 4-12 s each, seeds
    1234 + i, style windows (8, 264) of the 4 style clips in turn."""
    from ..infer.batch import Request
    from ..io import wav

    rng = np.random.default_rng(seed)
    requests, total_frames, lengths = [], 0, []
    for i in range(n_requests):
        seconds = float(rng.uniform(4.0, 12.0))
        audio = speech_like(rng, int(seconds * 16000))
        ap = clips_dir / f"req_{i}.wav"
        wav.write_wavefile(ap, np.clip(audio, -0.99, 0.99), 16000)
        n_frames = int(round(60.0 * seconds))
        total_frames += n_frames
        lengths.append(n_frames)
        requests.append(Request(
            audio=ap, styles=[(style_paths[i % 4], (8, 8 + 256))],
            file_name=f"req_{i}", temperature=1.0, seed=1234 + i,
        ))
    return requests, total_frames, lengths


def build_corpus(root, n_requests=20, seed=0, tiny=False):
    """Synthetic data dir + networks + request list at the v1 width (or the
    ``--tiny`` one) -> (net_dir, data_dir, requests, total_frames, options,
    lengths).

    Everything is deterministic (fixed seeds), so a marker file lets re-runs
    under the same root skip the networks and the style BVHs; only the
    request WAVs are written again. The marker names the widths, so another
    width builds anew."""
    from ..io import bvh, checkpoint, weights
    from ..train.loop import init_networks

    root = Path(root)
    data_dir, net_dir, clips_dir = root / "processed", root / "models", root / "clips"
    for d in (data_dir, net_dir, clips_dir):
        d.mkdir(parents=True, exist_ok=True)
    w = width(tiny)
    names, parents = _skeleton(w.njoints)
    net = w.options.net
    fingerprint = (f"{w.njoints}-{w.pose_in}-{w.pose_out}-{net.decoder.nhidden}-"
                   f"{net.speech_encoder.speech_encoding_size}-"
                   f"{net.style_encoder.style_encoding_size}-corpus-torch-v1")
    marker = root / "corpus_marker.txt"
    style_paths = [clips_dir / f"style_{i}.bvh" for i in range(4)]
    cached = (
        marker.exists() and marker.read_text() == fingerprint
        and all(p.exists() for p in style_paths)
        and all((net_dir / f"{n}.npz").exists()
                for n in ("speech_encoder", "decoder", "style_encoder"))
    )
    if not cached:
        marker.unlink(missing_ok=True)
        (data_dir / "data_definition.json").write_text(json.dumps({
            "dt": DT, "label_names": ["Neutral"], "parents": parents, "bone_names": names,
        }))
        conf = PipelineConfig(audio_conf=MelConfig(normalize_loudness=False)).to_dict()
        (data_dir / "data_pipeline_conf.json").write_text(json.dumps(conf))
        rng = np.random.default_rng(3)
        np.savez(
            data_dir / "stats.npz",
            audio_input_mean=rng.normal(size=AUDIO_DIM).astype(np.float32) * 0.1,
            audio_input_std=np.float32(1.0),
            anim_input_mean=np.zeros(w.pose_in, np.float32),
            anim_input_std=np.ones(w.pose_in, np.float32),
            anim_output_mean=np.zeros(w.pose_out, np.float32),
            anim_output_std=np.ones(w.pose_out, np.float32),
        )
        nets = init_networks(w.options, w.dims, nlabels=1, seed=0, device="cpu")
        for name, module in nets.items():
            checkpoint.save(net_dir / f"{name}.npz", weights.to_jax(module))
        # style examples: 4 shared BVH clips of 512 frames
        for i, p in enumerate(style_paths):
            bvh.save(p, _motion(512, seed=100 + i, njoints=w.njoints))
    requests, total_frames, lengths = _requests(clips_dir, style_paths, n_requests, seed)
    if not cached:
        marker.write_text(fingerprint)
    return net_dir, data_dir, requests, total_frames, w.options, lengths


# ---------------------------------------------------------------------------
# the card, the launch counters
# ---------------------------------------------------------------------------

def device_summary(device="cuda"):
    """The card a stage runs on: its name, its power limit and the number of
    cards, as `nvidia-smi --query-gpu=name,power.limit` gives them; on the
    CPU (a rehearsal) platform "cpu" and no card."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None, "count": 0}
    index = torch.cuda.current_device() if device.index is None else device.index
    line = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "name": torch.cuda.get_device_name(index),
            "power_limit": line.rsplit(",", 1)[1].strip(), "nvidia_smi": line,
            "count": torch.cuda.device_count()}


def missing_launches(counts, required, device):
    """The kernels of ``required`` a run on the card launched no time (on the
    CPU the wrappers run their plain versions and count nothing)."""
    if device.type != "cuda":
        return []
    return [k for k in required if not counts.get(k)]


# ---------------------------------------------------------------------------
# a stage's arguments and output
# ---------------------------------------------------------------------------

def stage_parser(description):
    """The arguments every stage takes: ``--device`` (the card unless the
    caller asks for the CPU) and ``--tiny``."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--tiny", action="store_true",
                    help="8 joints and narrow widths: a rehearsal, with --device cpu only")
    return ap


def parse_stage_args(ap, argv=None):
    """Parse a stage's arguments and resolve its device: ``--tiny`` off the
    CPU is refused, and a missing card raises (`device.require_device`)."""
    from ..device import require_device

    import torch

    args = ap.parse_args(argv)
    if args.tiny and torch.device(args.device).type != "cpu":
        ap.error("--tiny is a rehearsal on the CPU: add --device cpu (a card runs the v1 width)")
    return args, require_device(args.device)


def emit(result):
    print(json.dumps(result), flush=True)


def start_watchdog(budget, result, t_main):
    """With a budget (seconds, 0 = none), a thread that prints ``result`` as
    it stands, marked ``watchdog_fired``, and ends the process with exit
    code 0 at budget + 5 s, unless the returned event is set first: the
    stage's JSON line comes out even when one phase holds the main thread
    past the budget."""
    finished = threading.Event()
    if budget:
        def _watchdog():
            if not finished.wait(timeout=budget + 5.0):
                cut = {"watchdog_fired": True,
                       "elapsed_s": round(time.perf_counter() - t_main, 1)}
                for _ in range(3):  # the main thread may add a key while it is read
                    try:
                        line = json.dumps({**result, **cut})
                        break
                    except RuntimeError:
                        line = json.dumps(cut)
                print(line, flush=True)
                sys.stderr.flush()
                os._exit(0)

        threading.Thread(target=_watchdog, daemon=True, name="bench-watchdog").start()
    return finished


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


class PhaseCounts:
    """Kernel launches a stage's phases make: ``total`` (a dict that a
    partial JSON line can hold while it grows) and ``by_phase``. Counting
    starts when the object is made."""

    def __init__(self):
        from ..ops.kernels import build

        self.total = dict.fromkeys(build.KERNELS, 0)
        self.by_phase = {}
        self._last = build.launches()

    def close(self, phase):
        """The launches since the last close (or the start) belong to
        ``phase``."""
        from ..ops.kernels import build

        now = build.launches()
        counts = {k: n - self._last[k] for k, n in now.items()}
        self._last = now
        self.by_phase[phase] = counts
        for k, n in counts.items():
            self.total[k] += n
