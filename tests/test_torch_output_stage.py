"""The batched output stage of zeggs_tpu_torch on the CPU: the transfer dtype
(`GesturePipeline(transfer_dtype=...)`, ZEGGS_TRANSFER_DTYPE), the rotations
converted inside the rollout programs (`programs.output_stage`), and
`generate_batch`'s pipelined chunks, held to zeggs_tpu on the same
synthetic corpus and weights as tests/test_torch_batch.py.

Budgets: float16 against float32 transfer, and the port's float16 against
zeggs_tpu's, are those of tests/test_batch_infer.py's float16 test (Euler
angles modulo 360: max < 3 degrees, median < 0.05; positions atol 0.5), and
against float32 the angle between the written rotations < 0.2 degrees
(F16_ROTATION_DEG: the quaternions are normalised after the upcast); a
program's output stage against `with_quaternions` of the eager
`decoder.rollout`, bit for bit; several chunks, with and without a mesh,
against zeggs_tpu's `generate_batch`, the paths in the same order and each
BVH within tests/test_torch_batch.py's batched budget (BVH channels atol
2e-3, rotations as matrix entries); chunks collected at depth 2 against
depth 0, bit for bit. The BVH's channels on the device, which
`generate_batch` computes after each chunk's output stage:
`utils.bvh_channels` over a batch against each clip's host path to float32
rounding, `generate_batch`'s BVHs against `write_result`'s of the same
rollouts within 1e-5 (and two float32 ulps), and the ``bvh.device_bakes`` /
``bvh.host_bakes`` counters of both paths.
"""

import csv

import numpy as np
import pytest
import torch

from zeggs_tpu.infer import GesturePipeline as JaxPipeline
from zeggs_tpu.infer.batch import Request as JaxRequest
from zeggs_tpu.infer.batch import generate_batch as jax_generate_batch
from zeggs_tpu.io import bvh, wav
from zeggs_tpu_torch.cli import generate as cli
from zeggs_tpu_torch.infer import batch as B
from zeggs_tpu_torch.infer import generate as G
from zeggs_tpu_torch.infer.batch import generate_batch
from zeggs_tpu_torch.infer.programs import ProgramCache, output_stage, with_quaternions
from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.ops import quat
from zeggs_tpu_torch.parallel import create_mesh
from zeggs_tpu_torch.utils import bvh_channels, profiling, save_channels, write_bvh
from tests.synthetic import make_audio
from tests.test_torch_batch import ATOL, BUCKET, NFRAMES, _matrices, _port, _rollout_inputs
from tests.test_torch_batch import corpus  # noqa: F401

SHORT = 100  # frames of the short clips: bucket 128, the others' 192
MAX_BATCH = 2
# float16 rounds each component of a unit quaternion by at most ~2.4e-4,
# which turns the rotation by at most ~0.06 degrees, and the root joint's BVH
# rotation composes three such quaternions: the angle between a float16
# transfer's rotations (normalised on the host) and float32's
F16_ROTATION_DEG = 0.2
#: two float32 ulps, relative: the rounding by which the same float32 math
#: may differ on another shape
F32_ULPS = 2.4e-7


@pytest.fixture(scope="module")
def requests_csv(corpus):  # noqa: F811
    """7 requests over two length buckets (4 of 150 frames, 3 of 100),
    interleaved, at temperature 0 (JAX and torch draw different noise)."""
    c = corpus
    for i in range(3):
        wav.write_wavefile(c["root"] / f"short_{i}.wav", make_audio(SHORT / 60, seed=30 + i),
                           16000)
    audios = [c["clips"][0][1].name, "short_0.wav", c["clips"][1][1].name, "short_1.wav",
              c["clips"][2][1].name, "short_2.wav", c["clips"][0][1].name]
    path = c["root"] / "seven.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["base_path", "audio", "style", "file_name",
                                          "temperature", "seed", "frames", "first_pose",
                                          "generate"])
        w.writeheader()
        for i, audio in enumerate(audios):
            w.writerow({"base_path": str(c["root"]), "audio": audio,
                        "style": c["clips"][(i + 1) % 3][0].name, "file_name": f"r{i}",
                        "temperature": "0.0", "seed": str(40 + i), "frames": "",
                        "first_pose": "", "generate": "TRUE"})
    with open(path, newline="") as f:
        return cli._requests(list(csv.DictReader(f)), "example")


def _jax_requests(reqs):
    return [JaxRequest(audio=r.audio, styles=r.styles, file_name=r.file_name,
                       temperature=r.temperature, seed=r.seed) for r in reqs]


@pytest.fixture(scope="module")
def jax_seven(corpus, requests_csv):  # noqa: F811
    c = corpus
    out = c["root"] / "jax_seven"
    written = jax_generate_batch(JaxPipeline(c["nets"], c["data"], options=c["opts"]),
                                 _jax_requests(requests_csv), out, bucket=BUCKET,
                                 max_batch=MAX_BATCH)
    return out, [p.name for p in written]


def _frames(name):
    return SHORT if name in ("r1", "r3", "r5") else NFRAMES


def _assert_close(a_path, b_path, frames, atol=ATOL):
    a, b = bvh.load(a_path), bvh.load(b_path)
    assert a["rotations"].shape == b["rotations"].shape == (frames, 8, 3)
    np.testing.assert_allclose(_matrices(a), _matrices(b), atol=atol, rtol=0)
    np.testing.assert_allclose(a["positions"], b["positions"], atol=atol, rtol=0)


def _assert_float16_close(a_path, b_path):
    """tests/test_batch_infer.py's float16 bounds -> the largest angle between
    the two files' rotations, in degrees."""
    a, b = bvh.load(a_path), bvh.load(b_path)
    dr = (np.asarray(a["rotations"]) - np.asarray(b["rotations"]) + 180.0) % 360.0 - 180.0
    assert np.abs(dr).max() < 3.0, np.abs(dr).max()
    assert np.median(np.abs(dr)) < 0.05, np.median(np.abs(dr))
    np.testing.assert_allclose(a["positions"], b["positions"], atol=0.5)
    qa, qb = (quat.from_euler(torch.deg2rad(torch.as_tensor(x["rotations"], dtype=torch.float64)),
                              x["order"]) for x in (a, b))
    cos = torch.clamp((qa * qb).sum(-1).abs(), max=1.0)
    return float(torch.rad2deg(2 * torch.acos(cos)).max())


# -- several chunks ----------------------------------------------------------------


@pytest.mark.parametrize("mesh", [None, 2], ids=["one_device", "mesh_of_two"])
def test_several_chunks_match_jax_in_order(corpus, requests_csv, jax_seven, tmp_path,  # noqa: F811
                                           mesh):
    c = corpus
    jax_out, jax_names = jax_seven
    written = generate_batch(_port(c), requests_csv, tmp_path, bucket=BUCKET,
                             max_batch=MAX_BATCH,
                             mesh=None if mesh is None else create_mesh(devices=["cpu"] * mesh))
    assert [p.name for p in written] == jax_names
    assert len(jax_names) == len(set(jax_names)) == 7
    for name in jax_names:
        _assert_close(tmp_path / name, jax_out / name, _frames(name[:-4]))


def test_pipeline_depth_changes_nothing(corpus, requests_csv, tmp_path, monkeypatch):  # noqa: F811
    """Four chunks collected two dispatches late and at once: the same
    files, byte for byte, in the same order."""
    c = corpus
    pipe = _port(c)
    texts = {}
    for depth in (B.PIPELINE_DEPTH, 0):
        monkeypatch.setattr(B, "PIPELINE_DEPTH", depth)
        out = tmp_path / str(depth)
        written = generate_batch(pipe, requests_csv, out, bucket=BUCKET, max_batch=MAX_BATCH)
        texts[depth] = [(p.name, p.read_text()) for p in written]
    assert B.PIPELINE_DEPTH == 0 and texts[2] == texts[0]


# -- the transfer dtype ------------------------------------------------------------


@pytest.mark.parametrize("how", ["environment", "argument"])
def test_float16_transfer_tracks_float32(corpus, requests_csv, tmp_path, monkeypatch,  # noqa: F811
                                         how):
    c = corpus
    generate_batch(_port(c), requests_csv, tmp_path / "f32", bucket=BUCKET, max_batch=MAX_BATCH)
    if how == "environment":
        monkeypatch.setenv("ZEGGS_TRANSFER_DTYPE", "float16")
        pipe = _port(c)
    else:
        pipe = _port(c, transfer_dtype="float16")
    assert pipe.transfer_dtype == torch.float16
    generate_batch(pipe, requests_csv, tmp_path / "f16", bucket=BUCKET, max_batch=MAX_BATCH)
    for r in requests_csv:
        angle = _assert_float16_close(tmp_path / "f32" / f"{r.file_name}.bvh",
                                      tmp_path / "f16" / f"{r.file_name}.bvh")
        assert angle < F16_ROTATION_DEG, (r.file_name, angle)


def test_float16_transfer_tracks_jax_float16(corpus, requests_csv, tmp_path):  # noqa: F811
    c = corpus
    reqs = requests_csv[:2]  # one clip of each bucket
    jax_generate_batch(JaxPipeline(c["nets"], c["data"], options=c["opts"],
                                   transfer_dtype="float16"),
                       _jax_requests(reqs), tmp_path / "jax", bucket=BUCKET)
    generate_batch(_port(c, transfer_dtype="float16"), reqs, tmp_path / "port", bucket=BUCKET)
    for r in reqs:
        _assert_float16_close(tmp_path / "jax" / f"{r.file_name}.bvh",
                              tmp_path / "port" / f"{r.file_name}.bvh")


@pytest.mark.parametrize("how", ["environment", "argument"])
def test_an_unknown_transfer_dtype_raises(corpus, monkeypatch, how):  # noqa: F811
    if how == "environment":
        monkeypatch.setenv("ZEGGS_TRANSFER_DTYPE", "half")
        kw = {}
    else:
        kw = {"transfer_dtype": "float64"}
    with pytest.raises(ValueError, match="transfer_dtype must be one of"):
        _port(corpus, **kw)


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32"])
def test_transfer_dtype_names(corpus, monkeypatch, name):  # noqa: F811
    """The argument wins over the environment; both name the cast of B=1
    rollouts (here the int8 kernel's plain version) and batched ones."""
    monkeypatch.setenv("ZEGGS_TRANSFER_DTYPE", "float32" if name != "float32" else "float16")
    pipe = _port(corpus, rollout_weights="int8", transfer_dtype=name)
    assert pipe.transfer_dtype == getattr(torch, name)
    for rows in (1, 2):
        with torch.inference_mode():
            out = pipe.rollout_batch(*_rollout_inputs(pipe, corpus, rows))
        assert [o.dtype for o in out] == [getattr(torch, name)] * 4
        assert [tuple(o.shape[2:]) for o in out] == [(3,), (4,), (8, 3), (8, 4)]


def test_write_result_upcasts_on_the_host(corpus, tmp_path):  # noqa: F811
    """A float16 result writes the BVH of its float32 upcast, the
    quaternions normalised; a float32 result is written as it is."""
    pipe = _port(corpus, transfer_dtype="float16")
    with torch.inference_mode():
        out = pipe.rollout_batch(*_rollout_inputs(pipe, corpus, 1))
    assert out[0].dtype == torch.float16
    rp, rr, lp, lr = (o.float() for o in out)
    assert (lr.norm(dim=-1) - 1).abs().max() > 1e-5  # float16 leaves the unit sphere
    a = pipe.write_result(tmp_path, "half", out)
    b = pipe.write_result(tmp_path, "upcast", (rp, rr / rr.norm(dim=-1, keepdim=True), lp,
                                               lr / lr.norm(dim=-1, keepdim=True)))
    c = pipe.write_result(tmp_path, "raw", (rp, rr, lp, lr))
    assert a.read_text() == b.read_text() != c.read_text()


def test_generate_gesture_follows_the_transfer_dtype(corpus, tmp_path):  # noqa: F811
    c = corpus
    for name in ("float32", "float16"):
        G.generate_gesture(c["clips"][0][1], [(c["clips"][1][0], None)], None, None,
                           tmp_path / name, file_name="one", temperature=0.0,
                           pipeline=_port(c, transfer_dtype=name))
    _assert_float16_close(tmp_path / "float32" / "one.bvh", tmp_path / "float16" / "one.bvh")


# -- the output stage inside the programs -------------------------------------------


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.float16, torch.bfloat16])
def test_program_output_stage_is_the_eager_one_bit_for_bit(corpus, dtype):  # noqa: F811
    """3 rows of 150 frames: 149 steps as 9 x 16, 1 x 4 and 1 x 1 grains,
    then the chunk's finish program, against the eager rollout converted
    (and cast) as a whole; without a dtype, the rot6d output."""
    pipe = _port(corpus)
    state0, gaze, speech, style = _rollout_inputs(pipe, corpus, 3)
    s = pipe.stats
    with torch.inference_mode():
        ref = D.rollout(pipe.networks["decoder"], *state0, gaze, speech, style,
                        s["anim_input_mean"], s["anim_input_std"], s["anim_output_mean"],
                        s["anim_output_std"], pipe.dt, output_indices=(0, 1, 4, 5))
        got = ProgramCache(pipe.networks["decoder"], s, pipe.dt).rollout(
            state0, gaze, speech, style, output_dtype=dtype)
    if dtype is None:
        want = ref
    else:
        want = with_quaternions(ref) if dtype == torch.float32 else output_stage(ref, dtype)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("mesh", [None, 2], ids=["one_device", "mesh_of_two"])
def test_warmup_makes_every_finish_program(corpus, requests_csv, tmp_path, mesh):  # noqa: F811
    """`warmup` over the seven requests' lengths makes one finish program
    and one bake program for each planned (B_pad, T_pad), of a block's rows
    under a mesh (the blocks share them), and `generate_batch` afterwards
    makes none."""
    pipe = _port(corpus)
    mesh = None if mesh is None else create_mesh(devices=["cpu"] * mesh)
    n_dev = 1 if mesh is None else mesh.size
    out = B.warmup(pipe, [_frames(f"r{i}") for i in range(7)], bucket=BUCKET,
                   max_batch=MAX_BATCH, mesh=mesh)
    want = {(b // n_dev, t, torch.float32) for t, b in out["compiled"]}
    assert out["complete"] and len(want) == len(out["compiled"]) >= 2
    assert {key[1:] for key, _ in pipe.programs.finishes()} == want
    assert {key[1:] for key, _ in pipe.programs.bakes()} == want
    generate_batch(pipe, requests_csv, tmp_path, bucket=BUCKET, max_batch=MAX_BATCH, mesh=mesh)
    assert {key[1:] for key, _ in pipe.programs.finishes()} == want
    assert {key[1:] for key, _ in pipe.programs.bakes()} == want


# -- the BVH's channels on the device ----------------------------------------------


def _model_space(rng, shape, J):
    """Random (root_pos, root_rot, lpos, lrot) of ``shape`` = (..., T), unit
    quaternions, float32."""
    def unit(*s):
        q = rng.normal(size=s + (4,))
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    return tuple(torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.normal(size=shape + (3,)) * 50.0, unit(*shape), rng.normal(size=shape + (J, 3)) * 10.0,
        unit(*shape, J)))


def test_bvh_channels_of_a_batch_equal_each_clips_host_path(tmp_path):
    """`bvh_channels` over a (3, 90) batch, re-anchored to the origin and
    the identity, equals row by row the channels of each clip alone, as `write_bvh`
    computes them on the host, to float32 rounding; and the written files
    read back alike."""
    B, T, J = 3, 90, 8
    parents, names = [-1, 0, 1, 2, 3, 4, 3, 6], [f"j{j}" for j in range(J)]
    clips = _model_space(np.random.default_rng(5), (B, T), J)
    positions, rotations = bvh_channels(*clips, reanchor=True)
    assert positions.shape == rotations.shape == (B, T, J, 3)
    for b in range(B):
        p, r = bvh_channels(*(x[b] for x in clips), reanchor=True)
        torch.testing.assert_close(positions[b], p, rtol=1.3e-6, atol=1e-5)
        torch.testing.assert_close(rotations[b], r, rtol=1.3e-6, atol=1e-5)
        write_bvh(tmp_path / f"host{b}.bvh", *(x[b].numpy() for x in clips), parents, names,
                  start_position=np.zeros(3), start_rotation=np.array([1.0, 0.0, 0.0, 0.0]))
        save_channels(tmp_path / f"batch{b}.bvh", positions[b].numpy(), rotations[b].numpy(),
                      parents, names)
        host, batch = bvh.load(tmp_path / f"host{b}.bvh"), bvh.load(tmp_path / f"batch{b}.bvh")
        for key in ("offsets", "positions", "rotations"):
            np.testing.assert_allclose(batch[key], host[key], atol=1e-5, rtol=0)


def test_generate_batch_writes_the_bvhs_of_the_host_path(corpus, requests_csv, tmp_path,  # noqa: F811
                                                          monkeypatch):
    """The seven requests through `generate_batch`, whose chunks' channels
    are computed on the device, against each chunk's rollout on the same
    inputs written by `write_result` (the host path): the BVHs read back
    within 1e-5 and F32_ULPS of the value (the same float32 math, whose
    vectorised and scalar loops split a chunk of T_pad frames at other
    elements than a clip of n: an element may differ by an ulp, 1.5e-5 at
    128)."""
    pipe = _port(corpus)
    rollout_batch, chunks = pipe.rollout_batch, []

    def recorded(*args):
        out = rollout_batch(*args)
        chunks.append(args)
        return out

    monkeypatch.setattr(pipe, "rollout_batch", recorded)
    written = iter(generate_batch(pipe, requests_csv, tmp_path / "batch", bucket=BUCKET,
                                  max_batch=MAX_BATCH))
    monkeypatch.undo()
    n_written = 0
    for args in chunks:  # every chunk is full: 4 + 3 requests in chunks of at most two
        with torch.inference_mode():
            out = pipe.rollout_batch(*args)
        for row in range(out[0].shape[0]):
            path = next(written)
            n = _frames(path.stem)
            host = pipe.write_result(tmp_path / "host", path.stem,
                                     tuple(t[row : row + 1, :n] for t in out))
            a, b = bvh.load(path), bvh.load(host)
            assert a["rotations"].shape == (n, 8, 3)
            for key in ("offsets", "positions", "rotations"):
                np.testing.assert_allclose(a[key], b[key], atol=1e-5, rtol=F32_ULPS)
            n_written += 1
    assert n_written == len(requests_csv) and next(written, None) is None


def test_counters_say_where_the_channels_were_computed(corpus, requests_csv, tmp_path):  # noqa: F811
    """`generate_batch` counts a ``bvh.device_bakes`` a clip and no
    ``bvh.host_bakes``; `generate_gesture` one host bake and no device
    bake."""
    c = corpus
    pipe = _port(c)

    def bakes(run):
        before = profiling.counters()
        run()
        after = profiling.counters()
        return tuple(after.get(k, 0) - before.get(k, 0)
                     for k in ("bvh.device_bakes", "bvh.host_bakes"))

    assert bakes(lambda: generate_batch(pipe, requests_csv, tmp_path / "batch", bucket=BUCKET,
                                        max_batch=MAX_BATCH)) == (len(requests_csv), 0)
    assert bakes(lambda: G.generate_gesture(c["clips"][0][1], [(c["clips"][1][0], None)], None,
                                            None, tmp_path / "one", file_name="one",
                                            temperature=0.0, pipeline=pipe)) == (0, 1)
