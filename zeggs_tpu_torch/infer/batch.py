"""Batched multi-clip inference (counterpart of `zeggs_tpu/infer/batch.py`).

Requests are bucketed by padded length (``bucket`` frames), cut into
chunks of at most ``max_batch`` clips and rolled out as one batched rollout
per chunk; BVH writing runs on a thread pool while the next chunk is
computed. A chunk of one clip takes the B=1 decoder kernel on a card;
larger chunks run the eager rollout with GRU1 of every step through the
GRU-cell kernel.

With a ``mesh`` (`parallel/mesh.py`) each chunk's rows are split into one
contiguous block a device (`shard_rows`). Everything before the rollout
stays on ``pipe.device``: audio features, style featurizing and the style
draws, so the draws do not depend on the mesh. One host thread a
non-empty block then copies its rows to its device, runs the speech
encoder and the eager rollout there on a stream of its own, in inference
mode (grad mode is per thread), and copies the outputs to the host. Every
chunk under a mesh runs the eager rollout, one of a single clip too, as
`zeggs_tpu`'s sharded path does; whether it runs int8 products is decided
by the chunk's size, not the block's. Blocks of a chunk reduce in another
order than the whole chunk (the GRU cell's batch tile follows B), so
sharded rows are close to, not bit-equal to, unsharded ones.

Length padding is exact for the speech encoder: features are
edge-repeated, which coincides with the encoder's replicate padding at the
true clip end; rollout frames past a clip's true length are computed and
discarded. Style examples of all requests are encoded in one batched call
per length bucket, and each request's style draws come from its own
`torch.Generator`, so a batched request gets the draws `generate_gesture`
makes for the same seed.

Left out, because they exist only for XLA's compile cache:
``resolve_batch_pad`` ("full" / "pow2") and the padding of B,
``plan_programs`` and ``warmup``. Eager PyTorch has no compiled programs
to bound.
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
from ..parallel import shard_rows
from ..utils import split_by_ratio

#: name prefix of the threads that run a mesh's blocks
SHARD_THREADS = "mesh-block"
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


def _shard_on(replica, rows, quantize_int8):
    dev = replica.device
    *state0, gaze, audio, style = (t.to(dev, non_blocking=True) for t in rows)
    speech = replica.encode_speech_batched(audio)
    out = replica.rollout_eager(tuple(state0), gaze, speech, style.contiguous(), quantize_int8)
    return [o.float().cpu() for o in out]


def _rollout_shard(replica, ready, rows, quantize_int8):
    """One block of a chunk on ``replica``, in a worker thread -> host
    trajectories. ``rows``: the block's 8 frame-0 state tensors, gaze,
    audio features and style, on the pipeline's device, written before the
    CUDA event ``ready`` (None when that device is the CPU). On a card the
    block runs on a stream of its own, which is idle when this returns."""
    dev = replica.device
    with torch.inference_mode():  # grad mode is per thread
        if dev.type != "cuda":
            if ready is not None:
                ready.synchronize()
            return _shard_on(replica, rows, quantize_int8)
        stream = torch.cuda.Stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            if ready is not None:
                stream.wait_event(ready)
            host = _shard_on(replica, rows, quantize_int8)
            stream.synchronize()
        return host


def _rollout_sharded(pipe, replicas, mesh, shards, state0, gaze, audio, style):
    """A chunk's rows over the mesh, one task of the pool ``shards`` a
    non-empty block -> host trajectories of the whole chunk, in row order.
    The int8 decision is the chunk's."""
    ready = None
    if pipe.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(pipe.device))
    blocks = zip(*(shard_rows(t, mesh) for t in (*state0, gaze, audio, style)))
    quantize_int8 = pipe.quantize_batched(audio.shape[0])
    futures = [shards.submit(_rollout_shard, replica, ready, rows, quantize_int8)
               for replica, rows in zip(replicas, blocks) if rows[0].shape[0]]
    outs = [f.result() for f in futures]
    return [torch.cat(parts) for parts in zip(*outs)]


@torch.inference_mode()
def generate_batch(pipe, requests, results_path, bucket=512, max_batch=64, mesh=None,
                   write_workers=4):
    """Run many requests as bucketed batched rollouts on ``pipe.device``, or
    with a ``mesh`` (`parallel.create_mesh`) each chunk's rows split over
    its devices.

    pipe: GesturePipeline. Writes <file_name>.bvh (and the .wav) of every
    request under ``results_path``; returns the written BVH paths, in the
    order of the requests' buckets and chunks. Returns once every block
    has finished."""
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

    replicas = None if mesh is None else [pipe.replica(d) for d in mesh.devices]
    with ThreadPoolExecutor(max_workers=write_workers) as pool, \
            ThreadPoolExecutor(max_workers=1 if mesh is None else mesh.size,
                               thread_name_prefix=SHARD_THREADS) as shards:
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
                if mesh is None:
                    speech = pipe.encode_speech_batched(audio)
                    out = pipe.rollout_batch(state0, gaze, speech, style.contiguous())
                    host = [o.float().cpu() for o in out]
                else:
                    host = _rollout_sharded(pipe, replicas, mesh, shards, state0, gaze, audio,
                                            style)
                for i, (req, _, n, *_) in enumerate(chunk):
                    futures.append(pool.submit(
                        pipe.write_result, results_path, req.file_name,
                        tuple(h[i : i + 1, :n] for h in host), req.audio,
                    ))
        return [f.result() for f in futures]
