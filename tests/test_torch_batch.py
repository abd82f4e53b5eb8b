"""Batched generation (`-b`) and int8 rollouts (`--int8`) of zeggs_tpu_torch on
the CPU, against zeggs_tpu and against the port's own single-request path.

The synthetic corpus of tests/synthetic.py (150 frames, 8 joints, small
widths) is read by both packages from the same files. Budget: BVH
channels atol 2e-3, the budget of tests/test_batch_infer.py: positions in
cm, and rotations as the entries of their rotation matrices. Euler angles
are not compared directly: near gimbal lock (a middle angle near +-90
degrees, which these random networks reach) a 1e-7 change of the
quaternion moves an angle by 5e-2 degrees. The JAX side runs at
temperature 0, the deterministic mu path, because jax.random and torch.Generator draw
different numbers; the port against itself runs at temperature 1, which
shows that each request's generator reproduces the single-request draws.
"""

import csv
import json

import numpy as np
import pytest
import torch

from zeggs_tpu.infer import GesturePipeline as JaxPipeline
from zeggs_tpu.infer.batch import Request as JaxRequest
from zeggs_tpu.infer.batch import generate_batch as jax_generate_batch
from zeggs_tpu.io import bvh
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.cli import generate as cli
from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
from zeggs_tpu_torch.infer import generate as G
from zeggs_tpu_torch.infer.batch import Request, generate_batch
from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.ops import quat
from zeggs_tpu_torch.ops.kernels import build
from tests.synthetic import write_corpus

NFRAMES = 150
ATOL = 2e-3
BUCKET = 64


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_batch_corpus")
    data_dir, net_dir, clips, opts = write_corpus(root, n_clips=3, nframes=NFRAMES)
    od = opts.to_options_dict()
    od["paths"] = {"base_path": str(root), "path_processed_data": "processed",
                   "output_dir": str(root / "out"), "models_dir": str(net_dir)}
    (root / "options.json").write_text(json.dumps(od))
    return dict(root=root, data=data_dir, nets=net_dir, clips=clips, opts=opts,
                topts=TC.Options.from_options_dict(od))


# name -> (audio clip, style clips, blend type, blend ratio, first pose clip)
REQUESTS = {
    "single": (0, [1], "add", [0.5, 0.5], None),
    "add": (1, [0, 2], "add", [0.3, 0.7], None),
    "stitch": (2, [0, 1], "stitch", [0.4, 0.6], 0),
}


def _requests(c, cls, temperature, seed=5):
    reqs = []
    for i, (name, (audio, styles, blend, ratio, first)) in enumerate(REQUESTS.items()):
        reqs.append(cls(
            audio=c["clips"][audio][1], styles=[(c["clips"][s][0], None) for s in styles],
            file_name=name, temperature=temperature, seed=seed + i, blend_type=blend,
            blend_ratio=ratio, first_pose=None if first is None else c["clips"][first][0],
        ))
    return reqs


def _port(c, **kw):
    return GesturePipeline(c["nets"], c["data"], options=c["topts"], device="cpu", **kw)


def _matrices(anim):
    """BVH Euler angles (degrees) -> rotation matrices, in float64."""
    rad = torch.deg2rad(torch.as_tensor(anim["rotations"], dtype=torch.float64))
    q = quat.from_euler(rad, anim["order"])
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).numpy()


def _assert_bvh_close(a_path, b_path, atol=ATOL):
    a, b = bvh.load(a_path), bvh.load(b_path)
    assert a["rotations"].shape == b["rotations"].shape == (NFRAMES, 8, 3)
    np.testing.assert_allclose(_matrices(a), _matrices(b), atol=atol, rtol=0)
    np.testing.assert_allclose(a["positions"], b["positions"], atol=atol, rtol=0)


@pytest.fixture(scope="module")
def jax_batch(corpus):
    c = corpus
    out = c["root"] / "jax_batch"
    jax_generate_batch(JaxPipeline(c["nets"], c["data"], options=c["opts"]),
                       _requests(c, JaxRequest, 0.0), out, bucket=BUCKET)
    return out


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_generate_batch_matches_jax(corpus, jax_batch, tmp_path, name):
    c = corpus
    written = generate_batch(_port(c), _requests(c, Request, 0.0), tmp_path, bucket=BUCKET)
    assert sorted(p.name for p in written) == sorted(f"{n}.bvh" for n in REQUESTS)
    _assert_bvh_close(tmp_path / f"{name}.bvh", jax_batch / f"{name}.bvh")
    assert (tmp_path / f"{name}.wav").exists()


@pytest.mark.parametrize("rollout_weights,max_batch", [("bfloat16", 64), ("int8", 1)])
def test_generate_batch_matches_single_requests(corpus, tmp_path, rollout_weights, max_batch):
    """Temperature 1, the same seeds: the batched style encoder draws what
    each single request draws. With int8 every chunk holds one clip, so
    both paths run the int8 decoder kernel's plain version."""
    c = corpus
    pipe = _port(c, rollout_weights=rollout_weights)
    reqs = _requests(c, Request, 1.0)
    generate_batch(pipe, reqs, tmp_path / "batch", bucket=BUCKET, max_batch=max_batch)
    for r in reqs:
        generate_gesture(r.audio, r.styles, None, None, tmp_path / "single",
                         blend_type=r.blend_type, blend_ratio=r.blend_ratio,
                         file_name=r.file_name, first_pose=r.first_pose,
                         temperature=r.temperature, seed=r.seed, pipeline=pipe)
        _assert_bvh_close(tmp_path / "batch" / f"{r.file_name}.bvh",
                          tmp_path / "single" / f"{r.file_name}.bvh")


def test_generate_batch_writes_every_chunk(corpus, tmp_path):
    """Five requests in chunks of two: every file is written at its true
    length, and equal requests give equal motion whatever their chunk."""
    c = corpus
    reqs = [Request(audio=c["clips"][i % 3][1], styles=[(c["clips"][(i + 1) % 3][0], None)],
                    file_name=f"chunk_{i}", temperature=0.0, seed=i) for i in range(5)]
    written = generate_batch(_port(c), reqs, tmp_path, bucket=BUCKET, max_batch=2)
    assert len(written) == 5
    for i in range(5):
        anim = bvh.load(tmp_path / f"chunk_{i}.bvh")
        assert anim["rotations"].shape[0] == NFRAMES
        assert np.isfinite(anim["rotations"]).all()
        assert (tmp_path / f"chunk_{i}.wav").exists()
    _assert_bvh_close(tmp_path / "chunk_0.bvh", tmp_path / "chunk_3.bvh", atol=1e-4)


def test_encode_styles_batch_matches_encode_style(corpus):
    """Length buckets of 64 frames, masked, and per-job draws in job order
    from each job's generator."""
    c = corpus
    pipe = _port(c)
    vecs = [pipe.style_example_from_bvh(c["clips"][i][0], frames)[0]
            for i, frames in ((0, None), (1, (10, 70)), (2, (0, 130)))]
    gen_a, gen_b = torch.Generator().manual_seed(3), torch.Generator().manual_seed(4)
    jobs = [(vecs[0], 1.0, gen_a), (vecs[1], 0.7, gen_b), (vecs[2], 1.0, gen_a),
            (vecs[1], 0.0, gen_b)]
    with torch.inference_mode():
        batched = pipe.encode_styles_batch(jobs)
        gen_a.manual_seed(3)
        gen_b.manual_seed(4)
        single = [pipe.encode_style(v, t, g)[0] for v, t, g in jobs]
    assert pipe.encode_styles_batch([]) == []
    for b, s in zip(batched, single):
        assert tuple(b.shape) == (1, c["topts"].net.style_encoder.style_encoding_size)
        torch.testing.assert_close(b, s, atol=2e-5, rtol=0)


def _rollout_inputs(pipe, c, B):
    with torch.inference_mode():
        vec, f0 = pipe.style_example_from_bvh(c["clips"][0][0])
        feats, n = pipe.audio_to_features(c["clips"][1][1])
        speech = pipe.encode_speech_batched(feats[None].expand(B, -1, -1))
        style = pipe.encode_style(vec, 0.0)[0][:, None].expand(B, n, -1).contiguous()
    state0 = tuple(getattr(f0, k)[0:1].expand(B, *getattr(f0, k).shape[1:]).contiguous()
                   for k in G._STATE0)
    return state0, f0.gaze_pos[0].expand(B, n, 3), speech, style


def test_int8_pipeline_on_cpu_runs_the_plain_int8_kernel(corpus, monkeypatch):
    c = corpus
    monkeypatch.setenv("ZEGGS_FUSED_INT8", "1")
    pipe = _port(c)
    assert pipe.rollout_weights == "int8" and pipe._fused_fn is not None
    args = _rollout_inputs(pipe, c, 1)
    launches = build.launches()
    with torch.inference_mode():
        out = pipe.rollout_batch(*args)
        ref = D.make_fused_b1_fn(pipe.networks["decoder"], pipe.stats["anim_input_mean"],
                                 pipe.stats["anim_input_std"], pipe.stats["anim_output_mean"],
                                 pipe.stats["anim_output_std"], pipe.dt,
                                 weights_dtype=torch.int8)(*args)
    assert build.launches() == launches
    for o, r in zip(out[:3], (ref[0], ref[1], ref[4])):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    assert all(torch.isfinite(o).all() for o in out)


@pytest.mark.parametrize("min_batch,quantized", [(G.INT8_BATCHED_MIN, False), (2, True)])
def test_batched_rollouts_quantize_from_the_threshold(corpus, monkeypatch, min_batch,
                                                      quantized):
    c = corpus
    monkeypatch.setattr(G, "INT8_BATCHED_MIN", min_batch)
    pipe = _port(c, rollout_weights="int8")
    state0, gaze, speech, style = _rollout_inputs(pipe, c, 2)
    s = pipe.stats
    launches = build.launches()
    with torch.inference_mode():
        out = pipe.rollout_batch(state0, gaze, speech, style)
        ref = D.rollout(pipe.networks["decoder"], *state0, gaze, speech, style,
                        s["anim_input_mean"], s["anim_input_std"], s["anim_output_mean"],
                        s["anim_output_std"], pipe.dt, output_indices=(0, 1, 4, 5),
                        quantize_int8=quantized)
    assert build.launches() == launches, "CPU tensors take the GRU cell's plain version"
    for o, r in zip(out[:3], ref[:3]):
        torch.testing.assert_close(o, r, rtol=0, atol=0)


def _write_csv(c, path, rows):
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["base_path", "audio", "style", "file_name",
                                          "temperature", "seed", "frames", "first_pose",
                                          "generate"])
        w.writeheader()
        for r in rows:
            w.writerow({"base_path": str(c["root"]), "frames": "", "first_pose": "",
                        "generate": "TRUE", **r})


@pytest.mark.parametrize("flags", [["-b"], ["--int8"], ["-b", "--int8"]])
def test_cli_batch_and_int8_write_bvhs(corpus, tmp_path, flags):
    c = corpus
    rows = [
        dict(audio=c["clips"][0][1].name, style=c["clips"][1][0].name, file_name="row0",
             temperature="0.5", seed="3", frames="20 100"),
        dict(audio=c["clips"][1][1].name, style=c["clips"][0][0].name, file_name="row1",
             temperature="1.0", seed="4", first_pose=c["clips"][2][0].name),
        dict(audio=c["clips"][2][1].name, style=c["clips"][0][0].name, file_name="skipped",
             temperature="1.0", seed="5", generate="FALSE"),
    ]
    _write_csv(c, tmp_path / "requests.csv", rows)
    out = tmp_path / "out"
    cli.main(["-o", str(c["root"] / "options.json"), "-c", str(tmp_path / "requests.csv"),
              "-p", str(out), "--device", "cpu", *flags])
    for name in ("row0", "row1"):
        anim = bvh.load(out / f"{name}.bvh")
        assert anim["rotations"].shape[0] == NFRAMES
        assert np.isfinite(anim["rotations"]).all() and np.isfinite(anim["positions"]).all()
    assert not (out / "skipped.bvh").exists()


def test_cli_batch_matches_cli_csv(corpus, tmp_path):
    """`-b` writes what the one-by-one CSV mode writes for the same rows."""
    c = corpus
    rows = [dict(audio=c["clips"][i][1].name, style=c["clips"][(i + 1) % 3][0].name,
                 file_name=f"row{i}", temperature="1.0", seed=str(10 + i)) for i in range(3)]
    _write_csv(c, tmp_path / "requests.csv", rows)
    base = ["-o", str(c["root"] / "options.json"), "-c", str(tmp_path / "requests.csv"),
            "--device", "cpu"]
    cli.main(base + ["-p", str(tmp_path / "batch"), "-b"])
    cli.main(base + ["-p", str(tmp_path / "csv")])
    for i in range(3):
        _assert_bvh_close(tmp_path / "batch" / f"row{i}.bvh", tmp_path / "csv" / f"row{i}.bvh")


def test_style_examples_are_cached_by_path_mtime_and_frames(corpus, tmp_path):
    import os
    import shutil

    c = corpus
    pipe = _port(c)
    path = tmp_path / "style.bvh"
    shutil.copy(c["clips"][0][0], path)
    first = pipe.style_example_from_bvh(path)
    assert pipe.style_example_from_bvh(path) is first
    part = pipe.style_example_from_bvh(path, (10, 70))
    assert part is not first and part[0].shape[0] == 60
    stat = path.stat()
    os.utime(path, ns=(stat.st_atime_ns, stat.st_mtime_ns + 1_000_000))
    again = pipe.style_example_from_bvh(path)
    assert again is not first
    torch.testing.assert_close(again[0], first[0], rtol=0, atol=0)
