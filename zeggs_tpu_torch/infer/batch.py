"""Batched multi-clip inference (counterpart of `zeggs_tpu/infer/batch.py`).

Requests are bucketed by padded length (``bucket`` frames), cut into
chunks of at most ``max_batch`` clips and rolled out as one batched rollout
per chunk; BVH writing runs on a thread pool while the next chunk is
computed. A chunk of one clip takes the B=1 decoder kernel on a card;
larger chunks run the eager rollout with GRU1 of every step through the
GRU-cell kernel.

Length padding is exact for the speech encoder: features are
edge-repeated, which coincides with the encoder's replicate padding at the
true clip end; rollout frames past a clip's true length are computed and
discarded. Style examples of all requests are encoded in one batched call
per length bucket, and each request's style draws come from its own
`torch.Generator`, so a batched request gets the draws `generate_gesture`
makes for the same seed.

Left out, because they exist only for XLA's compile cache or the TPU
mesh: ``resolve_batch_pad`` ("full" / "pow2") and the padding of B,
``plan_programs``, ``warmup`` and ``mesh`` sharding. Eager PyTorch has no
compiled programs to bound; ``warmup`` and ``plan_programs`` are to be
reconsidered with the serving daemon.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import features as F
from ..io import bvh
from ..utils import split_by_ratio

_STATE0 = ("root_pos", "root_rot", "root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt")


@dataclass
class Request:
    """One synthesis request (mirrors an evaluation CSV row,
    data/test/evaluation_example_based.csv)."""

    audio: Path
    styles: Sequence  # BVH (path, frames) pairs, embedding arrays or labels
    file_name: str
    temperature: float = 1.0
    seed: int = 1234
    first_pose: Optional[Path] = None
    frames: Optional[tuple] = None  # style example frame range
    blend_type: str = "add"  # "add" (mix) or "stitch" (transitions)
    blend_ratio: Sequence[float] = field(default_factory=lambda: [0.5, 0.5])


def _round_up(n, m):
    return (n + m - 1) // m * m


def _prepare(pipe, req: Request):
    """Per-request preparation (counterpart of `_prepare_host`): audio
    features, style-encode jobs (deferred to one batched call), first pose.
    The request's generator is seeded as `generate_gesture` seeds its own."""
    audio_features, n_frames = pipe.audio_to_features(req.audio)
    generator = torch.Generator(device=pipe.device)
    generator.manual_seed(req.seed)
    specs, jobs, feats = [], [], None  # spec: ("job", index) | ("const", (1, C))
    for style in req.styles:
        if isinstance(style, (tuple, list)) and isinstance(style[0], (str, Path)):
            vec, feats = pipe.style_example_from_bvh(style[0], style[1])
            jobs.append((vec, req.temperature, generator))
            specs.append(("job", len(jobs) - 1))
        elif isinstance(style, np.ndarray):
            specs.append(("const", torch.as_tensor(style, dtype=torch.float32,
                                                   device=pipe.device)[None]))
        else:  # a label
            specs.append(("const", pipe.label_encoding(style)))
    if req.first_pose is not None:
        feats = F.preprocess_animation(bvh.load(req.first_pose), device=pipe.device)
    if feats is None:
        raise ValueError(f"{req.file_name}: no first pose available: give first_pose or a BVH "
                         "style example")
    return audio_features, n_frames, specs, jobs, feats


def _blend(req: Request, encodings, n_frames):
    """Blend per-style (1, C) encodings (counterpart of `_blend_host`):
    (1, C) for "add", (1, n_frames, C) for "stitch"."""
    if len(encodings) <= 1:
        return encodings[0]
    if req.blend_type == "stitch":
        spans = split_by_ratio(n_frames, list(req.blend_ratio))
        return torch.cat([enc[:, None].expand(-1, b - a, -1) for enc, (a, b) in
                          zip(encodings, spans)], dim=1)
    ratio = torch.as_tensor(req.blend_ratio, dtype=torch.float32, device=encodings[0].device)
    return torch.einsum("nbc,n->bc", torch.stack(encodings), ratio)


def _pad_time(x, T_pad):
    """(n, ...) -> (T_pad, ...), repeating the last frame."""
    return torch.cat([x, x[-1:].expand(T_pad - x.shape[0], *x.shape[1:])])


@torch.inference_mode()
def generate_batch(pipe, requests, results_path, bucket=512, max_batch=64, write_workers=4):
    """Run many requests as bucketed batched rollouts on ``pipe.device``.

    pipe: GesturePipeline. Writes <file_name>.bvh (and the .wav) of every
    request under ``results_path``; returns the written BVH paths, in the
    order of the requests' buckets and chunks."""
    results_path = Path(results_path)
    results_path.mkdir(parents=True, exist_ok=True)

    prepped = [(req, *_prepare(pipe, req)) for req in requests]
    all_jobs, offsets = [], []
    for (_, _, _, _, jobs, _) in prepped:
        offsets.append(len(all_jobs))
        all_jobs.extend(jobs)
    encoded = pipe.encode_styles_batch(all_jobs)

    buckets = {}
    for (req, af, n, specs, _, feats), off in zip(prepped, offsets):
        encs = [encoded[off + s[1]] if s[0] == "job" else s[1] for s in specs]
        style = _blend(req, encs, n)[0]  # (C,) or (n, C)
        state = tuple(getattr(feats, a)[0] for a in _STATE0)
        item = (req, af, n, style, state, feats.gaze_pos[0])
        buckets.setdefault(max(bucket, _round_up(n, bucket)), []).append(item)

    with ThreadPoolExecutor(max_workers=write_workers) as pool:
        futures = []
        for T_pad, items in sorted(buckets.items()):
            for start in range(0, len(items), max_batch):
                chunk = items[start : start + max_batch]
                state0 = tuple(torch.stack([c[4][j] for c in chunk]) for j in range(len(_STATE0)))
                audio = torch.stack([_pad_time(af[:n], T_pad) for (_, af, n, *_) in chunk])
                gaze = torch.stack([gz.expand(T_pad, 3) for (*_, gz) in chunk])
                style = torch.stack([
                    _pad_time(se[:n], T_pad) if se.ndim == 2 else se.expand(T_pad, -1)
                    for (_, _, n, se, _, _) in chunk
                ])
                speech = pipe.encode_speech_batched(audio)
                out = pipe.rollout_batch(state0, gaze, speech, style.contiguous())
                host = [o.float().cpu() for o in out]
                for i, (req, _, n, *_) in enumerate(chunk):
                    futures.append(pool.submit(
                        pipe.write_result, results_path, req.file_name,
                        tuple(h[i : i + 1, :n] for h in host), req.audio,
                    ))
        return [f.result() for f in futures]
