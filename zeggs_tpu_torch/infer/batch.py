"""Batched multi-clip inference (counterpart of `zeggs_tpu/infer/batch.py`).

Requests are bucketed by padded length (``bucket`` frames) and cut into
chunks of at most ``max_batch`` clips; each chunk's rows are padded to the
batch size of the padding policy (`resolve_batch_pad`: "pow2" or "full",
`_chunk_b_pad`) and rolled out as one batched rollout, so that a few rollout
programs (`infer/programs.py`: CUDA graphs of the decoder step) serve every
chunk. A chunk of one row takes the B=1 decoder kernel on a card; larger
chunks replay the programs, GRU1 of every step through the GRU-cell kernel,
and then their output stage (quaternions, the transfer dtype) in one more
program (`programs.FinishProgram`). Every chunk's (and every mesh block's)
quaternion rollout then has its BVH channels computed on its device, in
one more graph (`Replica.bake`, `programs.bake`: float32, re-anchored, the
root baked into joint 0, Euler degrees), the math that
`GesturePipeline.write_result` runs on the host for B=1 generation and
streaming. So the float32 channels are what is copied to the host, and
the writer threads take numpy views of the pinned rows and only format and
write them (`GesturePipeline.write_channels`).

Chunks are pipelined as `zeggs_tpu`'s are: as soon as a chunk's device work
is enqueued, its outputs start to copy into pinned host buffers on a copy
stream (`_pull`). A chunk is collected, its copies waited for and its rows
handed to the BVH writers' thread pool, once a later chunk has been
dispatched and its copies have ended, and at the latest once
PIPELINE_DEPTH later chunks have been dispatched; so the card computes the
next chunks while the copies and the writing of the earlier ones go on,
and at most PIPELINE_DEPTH + 1 chunks' outputs are held. A chunk's inputs
are held until it is collected, since the streams of its blocks read them.
Results come back in request order whatever the depth.
`plan_programs` predicts the (T_pad, B_pad) shapes `generate_batch` will
run, and `warmup` captures and runs each of them once, before traffic.

Pad rows repeat the chunk's last frame-0 state and get zero audio, gaze
and style, as `zeggs_tpu`'s do; they are computed and discarded. The GRU
cell's batch tile follows B, so a padded chunk's real rows are close to,
not bit-equal to, an unpadded run's.

With a ``mesh`` (`parallel/mesh.py`) B is padded to a multiple of the
mesh's size and each chunk's rows are split into one contiguous block a
device (`shard_rows`), all of one size. Everything before the rollout
stays on ``pipe.device``: audio features, style featurizing and the style
draws, so the draws do not depend on the mesh. One host thread a block
then copies its rows to its device, runs the speech encoder and the
rollout there on a stream of its own, through its block's slot of the
replica's program cache, in inference mode (grad mode is per thread), and
starts its outputs' copies to the host; the chunk's futures are collected
at the same depth. Every chunk under a mesh runs the
programs, one of a single clip too, as `zeggs_tpu`'s sharded path does;
whether it runs int8 products is decided by the padded chunk's size, not
the block's. Blocks of a chunk reduce in another order than the whole
chunk, so sharded rows are close to, not bit-equal to, unsharded ones.

Length padding is exact for the speech encoder: features are
edge-repeated, which coincides with the encoder's replicate padding at the
true clip end; rollout frames past a clip's true length are computed and
discarded. Style examples of all requests are encoded in one batched call
per length bucket, and each request's style draws come from its own
`torch.Generator`, so a batched request gets the draws `generate_gesture`
makes for the same seed.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import features as F
from ..io import bvh
from ..parallel import shard_rows
from ..utils import profiling, split_by_ratio
from .programs import device_site

#: name prefix of the threads that run a mesh's blocks
SHARD_THREADS = "mesh-block"
#: the most chunks dispatched after a chunk before it is collected
#: (`zeggs_tpu`'s ``pipeline_depth``); it bounds the outputs held. A chunk
#: whose copies have ended is collected after one. 0 collects each chunk as
#: soon as it is dispatched.
PIPELINE_DEPTH = 2
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
    features, style-encode jobs (deferred to one batched call), the style
    example's features and the parsed first-pose BVH (featurized later,
    with the job's other first poses: `_first_poses`). The request's
    generator is seeded as `generate_gesture` seeds its own."""
    with profiling.annotate("zeggs:batch.audio"):
        audio_features, n_frames = pipe.audio_to_features(req.audio)
    generator = torch.Generator(device=pipe.device)
    generator.manual_seed(req.seed)
    specs, jobs, feats = [], [], None  # spec: ("job", index) | ("const", (1, C))
    for style in req.styles:
        if isinstance(style, (tuple, list)) and isinstance(style[0], (str, Path)):
            with profiling.annotate("zeggs:batch.style_example"):
                vec, feats = pipe.style_example_from_bvh(style[0], style[1])
            jobs.append((vec, req.temperature, generator))
            specs.append(("job", len(jobs) - 1))
        elif isinstance(style, np.ndarray):
            specs.append(("const", torch.as_tensor(style, dtype=torch.float32,
                                                   device=pipe.device)[None]))
        else:  # a label
            specs.append(("const", pipe.label_encoding(style)))
    pose = None
    if req.first_pose is not None:
        with profiling.annotate("zeggs:batch.first_pose"):
            pose = bvh.load(req.first_pose)
    elif feats is None:
        raise ValueError(f"{req.file_name}: no first pose available: give first_pose or a BVH "
                         "style example")
    return audio_features, n_frames, specs, jobs, feats, pose


def _first_poses(pipe, poses):
    """Featurize the requests' parsed first poses (None where a request has
    none), one `F.preprocess_animations` pass a group of clips that stack
    (`F.anim_groups`) -> an `AnimFeatures` or None a request."""
    posed = [i for i, pose in enumerate(poses) if pose is not None]
    anims = [poses[i] for i in posed]
    groups = F.anim_groups(anims)
    out = [None] * len(poses)
    for group in groups:
        with profiling.annotate("zeggs:batch.first_poses", len(group)):
            feats = F.preprocess_animations([anims[k] for k in group], device=pipe.device)
        for k, f in zip(group, feats):
            out[posed[k]] = f
    profiling.count("batch.first_poses", len(posed))
    profiling.count("batch.first_pose_passes", len(groups))
    return out


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


def resolve_batch_pad(batch_pad):
    """The chunk batch-padding policy.

    "pow2": pad each chunk's batch to the next power of two, so partial
    tail chunks reuse a small ladder of programs; right where compute
    scales with B, as on a card at B <= 64 (the GRU cell's batch tile
    follows B).
    "full": pad every chunk to ``max_batch``: one program per length
    bucket.
    "auto": "pow2". `zeggs_tpu` takes "full" only on a TPU, where a B <= 64
    rollout costs the same at any B."""
    if batch_pad == "auto":
        return "pow2"
    if batch_pad not in ("pow2", "full"):
        raise ValueError(f"batch_pad must be 'auto', 'pow2' or 'full', not {batch_pad!r}")
    return batch_pad


def _chunk_b_pad(B, max_batch, n_dev, batch_pad):
    """Padded batch size for a chunk of B requests under the policy."""
    if batch_pad == "full":
        return _round_up(max_batch, n_dev)
    B_pad = max(n_dev, 1 << (B - 1).bit_length())
    B_pad = _round_up(min(B_pad, max_batch), n_dev)
    return max(B_pad, _round_up(B, n_dev))


def plan_programs(lengths, bucket=512, max_batch=64, n_dev=1, batch_pad="auto"):
    """The (T_pad, B_pad) rollout shapes `generate_batch` will run for clips
    of these lengths (frames), sorted: its bucketing and chunking exactly.
    `warmup` captures them; operators size a deployment's set of programs
    with it."""
    batch_pad = resolve_batch_pad(batch_pad)
    buckets = {}
    for n in lengths:
        T_pad = max(bucket, _round_up(int(n), bucket))
        buckets.setdefault(T_pad, []).append(n)
    plan = []
    for T_pad, items in sorted(buckets.items()):
        for chunk_start in range(0, len(items), max_batch):
            B = len(items[chunk_start : chunk_start + max_batch])
            plan.append((T_pad, _chunk_b_pad(B, max_batch, n_dev, batch_pad)))
    return sorted(set(plan))


@torch.inference_mode()
def warmup(pipe, lengths, bucket=512, max_batch=64, mesh=None, style_jobs=None, all_pow2=False,
           deadline=None, log=None, batch_pad="auto"):
    """Capture the rollout programs for clips of the given lengths before
    traffic arrives.

    Runs each planned (T_pad, B_pad) chunk once on zero inputs, the speech
    encoder and the rollout, through the path `generate_batch` takes (with
    a ``mesh``, on each of its replicas, a block's slot each), so that every
    program that chunk needs is captured: one at a time, checking
    ``deadline`` (a ``time.monotonic`` value) between chunks.

    all_pow2: also every power-of-two batch size up to ``max_batch`` per
    length bucket, the shapes a micro-batching daemon's partial drains give
    under "pow2"; a no-op under "full". style_jobs: optional list of
    (example_len, count) to run the batched style encoder on. batch_pad:
    the policy `generate_batch` and the daemon will run with.

    Returns {"compiled": [(T_pad, B_pad), ...], "skipped": [...],
    "seconds": total, "complete": bool}: ``skipped`` names the shapes the
    deadline cut off, whose programs will be captured at their first use."""
    n_dev = mesh.size if mesh is not None else 1
    batch_pad = resolve_batch_pad(batch_pad)
    plan = plan_programs(lengths, bucket=bucket, max_batch=max_batch, n_dev=n_dev,
                         batch_pad=batch_pad)
    if all_pow2 and batch_pad == "pow2":
        pow2s, b = [], max(1, n_dev)
        while b <= max_batch:
            pow2s.append(b)
            b *= 2
        extra = [(t, b) for t in sorted({t for t, _ in plan}) for b in pow2s]
        # the plan first (it serves the known traffic), then the daemon's
        # partial-drain shapes, smallest first
        plan = plan + sorted(set(extra) - set(plan))

    dev, J = pipe.device, pipe.njoints
    n_audio = pipe.stats["audio_input_mean"].shape[0]
    replicas = None if mesh is None else [pipe.replica(d) for d in mesh.devices]
    t_start = time.monotonic()
    compiled, skipped = [], []

    def expired():
        return deadline is not None and time.monotonic() >= deadline

    with ThreadPoolExecutor(max_workers=n_dev, thread_name_prefix=SHARD_THREADS) as shards:
        for T_pad, B_pad in plan:
            if expired():
                skipped.append((T_pad, B_pad))
                continue
            t0 = time.monotonic()
            state0 = [torch.zeros((B_pad, *s), device=dev)
                      for s in ((3,), (4,), (3,), (3,), (J, 3), (J, 2, 3), (J, 3), (J, 3))]
            state0[1][:, 0] = 1.0  # identity root rotation
            state0[5][..., 0, 0] = state0[5][..., 1, 1] = 1.0  # identity joint rotations
            inputs = (tuple(state0), torch.zeros((B_pad, T_pad, 3), device=dev),
                      torch.zeros((B_pad, T_pad, n_audio), device=dev),
                      torch.zeros((B_pad, T_pad, pipe.style_encoding_size), device=dev))
            _collect(_run_chunk(pipe, replicas, mesh, shards, *inputs))  # inputs held till here
            if log:
                log(f"warm rollout T={T_pad} B={B_pad}: {time.monotonic() - t0:.1f}s")
            compiled.append((T_pad, B_pad))

    for L, count in style_jobs or []:
        if expired():
            # recorded, so that "complete" does not claim the style encoder
            # ran when the deadline fell between the two loops
            skipped.append(("style", int(L), int(count)))
            continue
        t0 = time.monotonic()
        generator = torch.Generator(device=dev)
        # an example vector is the pose input with its zeroed gaze slot
        pipe.encode_styles_batch([(torch.zeros((int(L), 6 + J * 15 + 3), device=dev), 1.0,
                                   generator) for _ in range(int(count))])
        if log:
            log(f"warm style-encode L={L} N={count}: {time.monotonic() - t0:.1f}s")

    return {"compiled": compiled, "skipped": skipped,
            "seconds": round(time.monotonic() - t_start, 1), "complete": not skipped}


def _pad_time(x, T_pad):
    """(n, ...) -> (T_pad, ...), repeating the last frame."""
    return torch.cat([x, x[-1:].expand(T_pad - x.shape[0], *x.shape[1:])])


def _pad_rows(x, pad):
    """(B, ...) -> (B + pad, ...), zero rows appended."""
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x


def _assemble(chunk, T_pad, B_pad):
    """A chunk's (state0, gaze, audio features, style) at T_pad frames and
    B_pad rows: pad rows repeat the last frame-0 state and get zero audio,
    gaze and style (`zeggs_tpu`'s `generate_batch`)."""
    pad = B_pad - len(chunk)
    state0 = tuple(torch.stack([c[4][j] for c in chunk] + [chunk[-1][4][j]] * pad)
                   for j in range(len(_STATE0)))
    audio = torch.stack([_pad_time(af[:n], T_pad) for (_, af, n, *_) in chunk])
    gaze = torch.stack([gz.expand(T_pad, 3) for (*_, gz) in chunk])
    style = torch.stack([_pad_time(se[:n], T_pad) if se.ndim == 2 else se.expand(T_pad, -1)
                         for (_, _, n, se, _, _) in chunk])
    return state0, _pad_rows(gaze, pad), _pad_rows(audio, pad), _pad_rows(style, pad)


def _pull(out):
    """Start copying a chunk's (or a block's) outputs to the host -> (host
    tensors, the CUDA event that follows the copies, or None on the CPU,
    where the outputs are the host tensors). On a card the copies wait on
    the caller's stream for the chunk's device work and run on the device's
    copy stream into pinned buffers; the device tensors are marked as read
    by that stream, so that the caching allocator does not hand their memory
    out before the copies end."""
    dev = out[0].device
    if dev.type != "cuda":
        return list(out), None
    copier = device_site(dev).copy_stream
    copier.wait_stream(torch.cuda.current_stream(dev))
    host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True) for o in out]
    with torch.cuda.stream(copier):
        for h, o in zip(host, out):
            h.copy_(o, non_blocking=True)
            o.record_stream(copier)
    copied = torch.cuda.Event()
    copied.record(copier)
    return host, copied


def _shard_on(replica, rows, quantize_int8, slot):
    dev = replica.device
    *state0, gaze, audio, style = (t.to(dev, non_blocking=True) for t in rows)
    speech = replica.encode_speech_batched(audio)
    return _pull(replica.bake(replica.rollout(tuple(state0), gaze, speech, style.contiguous(),
                                              quantize_int8, slot)))


def _rollout_shard(replica, ready, rows, quantize_int8, slot):
    """One block of a chunk on ``replica``, in a worker thread, through the
    programs of ``slot`` (the block's index) -> `_pull`'s (host tensors,
    event). ``rows``: the block's 8 frame-0 state tensors, gaze, audio
    features and style, on the pipeline's device, written before the CUDA
    event ``ready`` (None when that device is the CPU). On a card the block
    runs on a stream of its own, and its copies to the host are still
    running when this returns; so are reads of ``rows``, which the caller
    holds until the block is collected (`_collect`)."""
    dev = replica.device
    with torch.inference_mode():  # grad mode is per thread
        if dev.type != "cuda":
            if ready is not None:
                ready.synchronize()
            return _shard_on(replica, rows, quantize_int8, slot)
        stream = torch.cuda.Stream(dev)
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            if ready is not None:
                stream.wait_event(ready)
            return _shard_on(replica, rows, quantize_int8, slot)


def _rollout_sharded(pipe, replicas, mesh, shards, state0, gaze, audio, style):
    """A padded chunk's rows over the mesh, one task of the pool ``shards``
    a block -> the blocks' futures, in row order. The int8 decision is the
    chunk's."""
    ready = None
    if pipe.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(pipe.device))
    blocks = zip(*(shard_rows(t, mesh) for t in (*state0, gaze, audio, style)))
    quantize_int8 = pipe.quantize_batched(audio.shape[0])
    return [shards.submit(_rollout_shard, replica, ready, rows, quantize_int8, slot)
            for slot, (replica, rows) in enumerate(zip(replicas, blocks))]


def _run_chunk(pipe, replicas, mesh, shards, state0, gaze, audio, style):
    """Dispatch one padded chunk: speech encoder and rollout on
    ``pipe.device``, or over the ``mesh`` -> its blocks (one without a
    mesh), each `_pull`'s (host tensors, event) or a future of it."""
    if mesh is None:
        speech = pipe.encode_speech_batched(audio)
        out = pipe.rollout_batch(state0, gaze, speech, style.contiguous())
        return [_pull(pipe.replica(pipe.device).bake(out))]
    return _rollout_sharded(pipe, replicas, mesh, shards, state0, gaze, audio, style)


def _copied(blocks):
    """Whether every block of a dispatched chunk has returned and its copies
    to the host have ended; it does not wait."""
    for block in blocks:
        if isinstance(block, Future):
            if not block.done():
                return False
            block = block.result()
        if block[1] is not None and not block[1].query():
            return False
    return True


def _collect(blocks):
    """A dispatched chunk's blocks -> their host tensors, in row order,
    once every copy has ended (and with it every read of the chunk's
    inputs on its blocks' streams: the copies follow the blocks' work)."""
    hosts = []
    for block in blocks:
        host, copied = block.result() if isinstance(block, Future) else block
        if copied is not None:
            copied.synchronize()
        hosts.append(host)
    return hosts


def _write(pipe, results_path, req, channels):
    """A writer thread's task: one request's BVH channels (`_pull`'s host
    rows as numpy views) formatted and written, and its WAV copied."""
    with profiling.annotate("zeggs:batch.write", req.file_name):
        return pipe.write_channels(results_path, req.file_name, *channels, req.audio)


@torch.inference_mode()
def generate_batch(pipe, requests, results_path, bucket=512, max_batch=64, mesh=None,
                   write_workers=4, batch_pad="auto"):
    """Run many requests as bucketed batched rollouts on ``pipe.device``, or
    with a ``mesh`` (`parallel.create_mesh`) each chunk's rows split over
    its devices.

    pipe: GesturePipeline. batch_pad: the chunk batch-padding policy
    (`resolve_batch_pad`). Writes <file_name>.bvh (and the .wav) of every
    request under ``results_path``; returns the written BVH paths, in the
    order of the requests' buckets and chunks. Chunks are pipelined (see
    the module's docstring); returns once every block has finished and
    every BVH is written.

    Spans (`utils/profiling.py`): ``zeggs:batch`` the call; inside it
    ``zeggs:batch.featurize`` the requests' featurization: one
    ``zeggs:batch.prepare#<file_name>`` a request (``.audio``,
    ``.style_example``, ``.first_pose`` (the BVH parse) inside), then one
    ``zeggs:batch.first_poses#<clips>`` a pass over first poses that stack;
    ``.encode_styles``, then a chunk's ``.assemble``, ``.dispatch`` and
    ``.collect``, and the final ``.wait_writes``;
    ``zeggs:batch.write#<file_name>`` on a writer thread. Counters:
    ``batch.clips``, ``batch.frames`` (the requests' frames),
    ``batch.frames_rolled`` (B_pad x T_pad of every chunk),
    ``batch.first_poses`` (first poses featurized),
    ``batch.first_pose_passes`` (their passes) and ``bvh.device_bakes``
    (clips whose BVH channels were computed on the device)."""
    with profiling.annotate("zeggs:batch"):
        return _generate_batch(pipe, requests, results_path, bucket, max_batch, mesh,
                               write_workers, resolve_batch_pad(batch_pad))


def _generate_batch(pipe, requests, results_path, bucket, max_batch, mesh, write_workers,
                    batch_pad):
    results_path = Path(results_path)
    results_path.mkdir(parents=True, exist_ok=True)

    prepped, poses = [], []
    with profiling.annotate("zeggs:batch.featurize"):
        for req in requests:
            with profiling.annotate("zeggs:batch.prepare", req.file_name):
                *prep, pose = _prepare(pipe, req)
            prepped.append((req, *prep))
            poses.append(pose)
        first = _first_poses(pipe, poses)
    all_jobs, offsets = [], []
    for (_, _, _, _, jobs, _) in prepped:
        offsets.append(len(all_jobs))
        all_jobs.extend(jobs)
    with profiling.annotate("zeggs:batch.encode_styles"):
        encoded = pipe.encode_styles_batch(all_jobs)

    buckets = {}
    for (req, af, n, specs, _, example), pose_feats, off in zip(prepped, first, offsets):
        encs = [encoded[off + s[1]] if s[0] == "job" else s[1] for s in specs]
        style = _blend(req, encs, n)[0]  # (C,) or (n, C)
        feats = example if pose_feats is None else pose_feats
        state = tuple(getattr(feats, a)[0] for a in _STATE0)
        item = (req, af, n, style, state, feats.gaze_pos[0])
        buckets.setdefault(max(bucket, _round_up(n, bucket)), []).append(item)
    profiling.count("batch.clips", len(prepped))
    profiling.count("batch.frames", sum(p[2] for p in prepped))

    n_dev = 1 if mesh is None else mesh.size
    replicas = None if mesh is None else [pipe.replica(d) for d in mesh.devices]
    caches = [pipe.programs] if mesh is None else [r.programs for r in replicas]
    with ThreadPoolExecutor(max_workers=write_workers) as pool, \
            ThreadPoolExecutor(max_workers=n_dev, thread_name_prefix=SHARD_THREADS) as shards:
        futures, pending = [], []

        def collect(chunk, inputs, blocks):
            with profiling.annotate("zeggs:batch.collect"):
                hosts = _collect(blocks)  # only now may the chunk's inputs be freed
            for programs in caches:
                programs.settle()  # the chunk's rollout device time, its outputs here
            rows = hosts[0][0].shape[0]  # a block's rows; every block has as many
            for i, (req, _, n, *_) in enumerate(chunk):
                positions, rotations = hosts[i // rows]
                r = i % rows
                profiling.count("bvh.device_bakes")
                futures.append(pool.submit(
                    _write, pipe, results_path, req,
                    (positions[r, :n].numpy(), rotations[r, :n].numpy()),
                ))

        for T_pad, items in sorted(buckets.items()):
            for start in range(0, len(items), max_batch):
                chunk = items[start : start + max_batch]
                B_pad = _chunk_b_pad(len(chunk), max_batch, n_dev, batch_pad)
                profiling.count("batch.frames_rolled", B_pad * T_pad)
                with profiling.annotate("zeggs:batch.assemble"):
                    inputs = _assemble(chunk, T_pad, B_pad)
                with profiling.annotate("zeggs:batch.dispatch"):
                    blocks = _run_chunk(pipe, replicas, mesh, shards, *inputs)
                pending.append((chunk, inputs, blocks))
                while len(pending) > PIPELINE_DEPTH or (len(pending) > 1
                                                        and _copied(pending[0][2])):
                    collect(*pending.pop(0))
        for entry in pending:
            collect(*entry)
        with profiling.annotate("zeggs:batch.wait_writes"):
            return [f.result() for f in futures]
