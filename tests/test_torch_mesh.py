"""Multi-device batched generation of zeggs_tpu_torch on the CPU: the mesh
helpers (`parallel/mesh.py`), `generate_batch(mesh=...)` against
zeggs_tpu's sharded `generate_batch` and against the port's unsharded run,
and `GestureServer(mesh=...)`.

The CPU named several times stands for several devices: each entry of such
a mesh is its own replica, run from a thread of its own over the same
weights, so these tests drive the splitting, the worker threads (each in
inference mode of its own) and the gathering; the copies between cards and
the streams run only on a card (tests/test_torch_cuda.py).

The synthetic corpus of tests/test_torch_batch.py (150 frames, 8 joints,
small widths) is read by both packages. Budget: BVH channels atol 2e-3,
the budget of tests/test_torch_batch.py (positions in cm, rotations as the
entries of their rotation matrices): a block of a chunk reduces in another
order than the whole chunk, so sharded rows are close to, not bit-equal
to, unsharded ones. The JAX side runs at temperature 0, because jax.random
and torch.Generator draw different numbers; the port against itself runs
at temperature 1, which shows that the style draws do not depend on the
mesh.
"""

import base64
import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from zeggs_tpu.infer import GesturePipeline as JaxPipeline
from zeggs_tpu.infer.batch import Request as JaxRequest
from zeggs_tpu.infer.batch import generate_batch as jax_generate_batch
from zeggs_tpu.parallel import create_mesh as jax_create_mesh
from zeggs_tpu_torch.infer import generate as G
from zeggs_tpu_torch.infer.batch import Request, generate_batch
from zeggs_tpu_torch.infer.programs import ProgramCache
from zeggs_tpu_torch.ops.kernels import build
from zeggs_tpu_torch.ops.kernels import decoder_rollout as DR
from zeggs_tpu_torch.parallel import Mesh, create_mesh, create_mesh_for_batch, shard_rows
from zeggs_tpu_torch.serve import GestureServer
from zeggs_tpu_torch.utils import profiling
from tests.test_torch_batch import BUCKET, NFRAMES, _assert_bvh_close, _port, corpus  # noqa: F401
from tests.test_torch_serve import _b64, _frames, _get, _post, _samples

CPU4 = ["cpu"] * 4


def _requests(c, cls, temperature, n=5):
    """``n`` requests over the three clips, each styled by the next clip."""
    return [cls(audio=c["clips"][i % 3][1], styles=[(c["clips"][(i + 1) % 3][0], None)],
                file_name=f"m{i}", temperature=temperature, seed=10 + i) for i in range(n)]


# -- the mesh helpers ----------------------------------------------------------


def test_create_mesh_keeps_order_and_repeated_devices():
    mesh = create_mesh(devices=CPU4)
    assert isinstance(mesh, Mesh) and mesh.size == 4
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert create_mesh(2, devices=["cpu", torch.device("cpu"), "cpu"]).size == 2
    for n in (0, 5):
        with pytest.raises(ValueError):
            create_mesh(n, devices=CPU4)


@pytest.mark.parametrize("make", [
    lambda: create_mesh(devices=["cpu", "cuda:99"]),
    lambda: create_mesh_for_batch(4, devices=["cuda:99"] * 2),
    lambda: create_mesh(),
    lambda: create_mesh_for_batch(8),
])
def test_a_device_that_is_not_there_raises(make, monkeypatch):
    """An entry the process cannot see raises; the default (every card)
    raises without a card: nothing moves to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


@pytest.mark.parametrize("batch,n", [(8, 4), (6, 3), (5, 1), (3, 3), (1, 1)])
def test_create_mesh_for_batch_takes_the_most_devices_that_divide(batch, n):
    assert create_mesh_for_batch(batch, devices=CPU4).size == n


@pytest.mark.parametrize("rows,sizes", [(8, [2, 2, 2, 2]), (5, [2, 1, 1, 1]),
                                        (3, [1, 1, 1, 0])])
def test_shard_rows_gives_contiguous_blocks_in_order(rows, sizes):
    x = torch.arange(rows * 3.0).reshape(rows, 3)
    blocks = shard_rows(x, create_mesh(devices=CPU4))
    assert [b.shape[0] for b in blocks] == sizes
    assert all(b.shape[1:] == x.shape[1:] for b in blocks)
    assert torch.equal(torch.cat(blocks), x)
    assert all(b.data_ptr() == x[sum(sizes[:i]):].data_ptr() for i, b in enumerate(blocks) if len(b))


# -- generate_batch over a mesh -----------------------------------------------


@pytest.fixture(scope="module")
def sharded(corpus, tmp_path_factory):  # noqa: F811
    """Five requests (padded to eight rows, blocks of two) over four
    replicas: the port's and JAX's on four of its eight forced host devices,
    at temperature 0."""
    c = corpus
    root = tmp_path_factory.mktemp("mesh_batch")
    jax_generate_batch(JaxPipeline(c["nets"], c["data"], options=c["opts"]),
                       _requests(c, JaxRequest, 0.0), root / "jax", bucket=BUCKET, max_batch=8,
                       mesh=jax_create_mesh(4))
    written = generate_batch(_port(c), _requests(c, Request, 0.0), root / "port", bucket=BUCKET,
                             max_batch=8, mesh=create_mesh(devices=CPU4))
    return root, written


@pytest.mark.parametrize("i", range(5))
def test_sharded_generate_batch_matches_jax(sharded, i):
    root, written = sharded
    assert [p.name for p in written] == [f"m{k}.bvh" for k in range(5)]
    _assert_bvh_close(root / "port" / f"m{i}.bvh", root / "jax" / f"m{i}.bvh")
    assert (root / "port" / f"m{i}.wav").exists()


@pytest.mark.parametrize("n,mesh_size", [(5, 4), (3, 4), (4, 2)])
def test_sharded_equals_unsharded_at_temperature_1(corpus, tmp_path, n, mesh_size):  # noqa: F811
    """Five requests over four replicas (padded to eight rows), three over
    four (padded to four) and four over two: the same files, in the same
    order, as the run without a mesh, within the budget."""
    c = corpus
    pipe = _port(c)
    reqs = _requests(c, Request, 1.0, n)
    plain = generate_batch(pipe, reqs, tmp_path / "plain", bucket=BUCKET)
    meshed = generate_batch(pipe, reqs, tmp_path / "mesh", bucket=BUCKET,
                            mesh=create_mesh(devices=["cpu"] * mesh_size))
    assert [p.name for p in meshed] == [p.name for p in plain]
    for p in plain:
        _assert_bvh_close(tmp_path / "mesh" / p.name, p)


def test_one_clip_chunk_runs_the_eager_rollout_under_a_mesh(corpus, tmp_path, monkeypatch):  # noqa: F811
    """With int8 rollout weights a one-clip chunk takes the B=1 decoder
    kernel's plain version on the CPU; under a mesh (padded to four rows)
    it runs the rollout programs instead, at float32 products
    (4 < INT8_BATCHED_MIN), as zeggs_tpu's sharded path does. Its BVH
    equals a float32-products run without a mesh (a bfloat16 pipeline on
    the CPU has no B=1 kernel) within 1e-5."""
    c = corpus
    calls = []
    plain_b1 = DR.rollout_b1_plain
    monkeypatch.setattr(DR, "rollout_b1_plain", lambda *a, **k: calls.append(1) or plain_b1(*a, **k))
    pipe = _port(c, rollout_weights="int8")
    req = _requests(c, Request, 0.0, 1)
    generate_batch(pipe, req, tmp_path / "int8", bucket=BUCKET)
    assert len(calls) == 1  # the spy sees the B=1 kernel's path
    generate_batch(pipe, req, tmp_path / "mesh", bucket=BUCKET, mesh=create_mesh(devices=CPU4))
    assert len(calls) == 1
    generate_batch(_port(c, rollout_weights="bfloat16"), req, tmp_path / "eager", bucket=BUCKET)
    _assert_bvh_close(tmp_path / "mesh" / "m0.bvh", tmp_path / "eager" / "m0.bvh", atol=1e-5)


def test_int8_products_are_decided_by_the_chunk(corpus, tmp_path, monkeypatch):  # noqa: F811
    """Three clips over four replicas with int8 products from B=2: the chunk
    is padded to four rows, and every block of one row runs int8 products
    (through its slot of the program cache), because its chunk holds four."""
    c = corpus
    monkeypatch.setattr(G, "INT8_BATCHED_MIN", 2)
    seen = []
    rollout = ProgramCache.rollout
    monkeypatch.setattr(ProgramCache, "rollout", lambda self, *a: seen.append(
        (a[1].shape[0], a[4], a[5])) or rollout(self, *a))
    generate_batch(_port(c, rollout_weights="int8"), _requests(c, Request, 0.0, 3), tmp_path,
                   bucket=BUCKET, mesh=create_mesh(devices=CPU4))
    assert sorted(seen) == [(1, True, slot) for slot in range(4)]


def test_workers_run_in_inference_mode_of_their_own(corpus, tmp_path):  # noqa: F811
    """Decoder parameters that require grad: grad mode is per thread, so a
    worker that did not enter inference mode would record autograd on the
    caller's inference tensors and fail."""
    c = corpus
    pipe = _port(c)
    pipe.networks["decoder"].requires_grad_(True)
    reqs = _requests(c, Request, 0.0, 3)
    plain = generate_batch(pipe, reqs, tmp_path / "plain", bucket=BUCKET)
    generate_batch(pipe, reqs, tmp_path / "mesh", bucket=BUCKET,
                   mesh=create_mesh(devices=["cpu"] * 2))
    for p in plain:
        _assert_bvh_close(tmp_path / "mesh" / p.name, p)


def test_replica_on_the_pipelines_device_is_the_pipeline(corpus):  # noqa: F811
    pipe = _port(corpus)
    rep = pipe.replica("cpu")
    assert rep.device == torch.device("cpu") and rep.stats is pipe.stats
    assert rep.networks == {n: pipe.networks[n] for n in ("speech_encoder", "decoder")}


# -- the daemon ------------------------------------------------------------------


@contextlib.contextmanager
def _mesh_server(pipe, **kw):
    """A daemon on 127.0.0.1 whose batches are split over two replicas."""
    srv = GestureServer(pipe, mesh=create_mesh(devices=["cpu"] * 2), **kw)
    port = srv.start()
    try:
        yield port
    finally:
        srv.stop()


def test_server_splits_a_batch_over_its_mesh(corpus, tmp_path):  # noqa: F811
    """Three concurrent /synthesize requests coalesce into one batch (the
    drain ends when the third arrives) split over two replicas; each BVH
    equals `generate_batch` without a mesh within the budget; /healthz
    keeps its fields."""
    c = corpus
    pipe = _port(c)
    reqs = _requests(c, Request, 1.0, 3)
    replies = [None] * 3
    with _mesh_server(pipe, max_batch=3, max_wait_ms=60_000) as port:
        assert _get(port, "/healthz") == {"ok": True, "platform": "cpu", "device": "cpu",
                                          "style_encoding_type": "example"}

        def send(i):
            r = reqs[i]
            replies[i] = _post(port, "/synthesize", {
                "audio_path": str(r.audio), "style_path": str(r.styles[0][0]), "seed": r.seed,
                "file_name": r.file_name})

        threads = [threading.Thread(target=send, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    assert [r["batch_size"] for r in replies] == [3, 3, 3]
    generate_batch(pipe, reqs, tmp_path / "plain", bucket=512)
    for r in replies:
        (tmp_path / r["file_name"]).write_text(r["bvh"])
        _assert_bvh_close(tmp_path / r["file_name"], tmp_path / "plain" / f"{r['file_name']}.bvh")


def test_server_with_a_mesh_streams_as_before(corpus):  # noqa: F811
    """A stream over HTTP runs on the pipeline's device and equals an
    in-process session exactly."""
    c = corpus
    pipe = _port(c)
    style, audio = c["clips"][0]
    parts = np.array_split(_samples(audio), 3)
    with _mesh_server(pipe, max_batch=8, max_wait_ms=50) as port:
        out = _post(port, "/stream/start", {"styles": [{"bvh_b64": _b64(style)}], "seed": 7,
                                            "quantum": 16})
        chunks = [_frames(out["frames"])]
        for part in parts:
            chunks.append(_frames(_post(port, "/stream/push", {
                "session_id": out["session_id"],
                "audio_f32_b64": base64.b64encode(part).decode()})["frames"]))
        fin = _post(port, "/stream/finish", {"session_id": out["session_id"]})
        chunks.append(_frames(fin["frames"]))
    assert fin["total_frames"] == NFRAMES
    sess = pipe.streaming_session([(style, None)], seed=7, quantum=16)
    direct = [sess._collect(0)] + [sess.push(p) for p in parts] + [sess.finish()]
    for k in chunks[0]:
        np.testing.assert_array_equal(np.concatenate([ch[k] for ch in chunks]),
                                      np.concatenate([d[k] for d in direct]))


# -- launch counters -------------------------------------------------------------


@pytest.mark.parametrize("kernel", ["gru_cell", "mel_spectrogram", "decoder_rollout"],
                         ids=["gru_cell", "mel", "decoder_rollout"])
def test_launch_counter_counts_every_launch_from_many_threads(kernel):
    """16 threads add 2,000 launches each with the interpreter switching
    threads every microsecond: no count is lost (an unguarded
    ``launches += 1`` can lose one between its read and its write)."""
    before = build.launches()[kernel]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [profiling.count(f"{kernel}.launches") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert build.launches()[kernel] - before == 16 * 2000
