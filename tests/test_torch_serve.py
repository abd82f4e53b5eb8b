"""The serving daemon of zeggs_tpu_torch on the CPU: HTTP surface,
micro-batching, validation, caps and streaming sessions over HTTP (a fast
subset of tests/test_serve.py, against the port's own in-process paths)."""

import base64
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from zeggs_tpu.io import bvh, wav
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.cli import serve as cli
from zeggs_tpu_torch.infer import GesturePipeline
from zeggs_tpu_torch.infer.batch import Request, generate_batch
from zeggs_tpu_torch.serve import GestureServer
from tests.synthetic import write_corpus

NFRAMES = 180


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve_corpus")
    data_dir, net_dir, clips, opts = write_corpus(root, n_clips=2, nframes=NFRAMES)
    od = opts.to_options_dict()
    od["paths"] = {"base_path": str(root), "path_processed_data": "processed",
                   "output_dir": str(root / "out"), "models_dir": str(net_dir)}
    (root / "options.json").write_text(json.dumps(od))
    pipe = GesturePipeline(net_dir, data_dir, options=TC.Options.from_options_dict(od),
                           device="cpu")
    return dict(root=root, clips=clips, pipe=pipe)


@pytest.fixture(scope="module")
def server(corpus):
    srv = GestureServer(corpus["pipe"], max_batch=8, max_wait_ms=50)
    port = srv.start()
    yield srv, port
    srv.stop()


def _post(port, path, payload, timeout=300):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _post_code(port, path, payload):
    try:
        return 200, _post(port, path, payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _b64(path):
    return base64.b64encode(path.read_bytes()).decode()


def _frames(f):
    assert f["dtype"] == "float32"
    return {k: np.frombuffer(base64.b64decode(v["b64"]), np.float32).reshape(v["shape"])
            for k, v in f["data"].items()}


def _check_bvh(text, tmp_path):
    p = tmp_path / "resp.bvh"
    p.write_text(text)
    anim = bvh.load(p)
    assert anim["rotations"].shape[0] == NFRAMES
    assert np.isfinite(anim["rotations"]).all()
    return anim


def test_healthz(server):
    _, port = server
    out = _get(port, "/healthz")
    assert out == {"ok": True, "platform": "cpu", "device": "cpu",
                   "style_encoding_type": "example"}


def test_synthesize_equals_generate_batch(server, corpus, tmp_path):
    _, port = server
    style, audio = corpus["clips"][0]
    out = _post(port, "/synthesize", {"audio_path": str(audio), "style_path": str(style),
                                      "seed": 7, "file_name": "mine"})
    assert out["file_name"] == "mine" and out["batch_size"] == 1 and out["latency_ms"] > 0
    generate_batch(corpus["pipe"], [Request(audio=audio, styles=[(style, None)],
                                            file_name="direct", seed=7)], tmp_path)
    assert out["bvh"] == (tmp_path / "direct.bvh").read_text()


def test_stats_report_the_program_counters(server, corpus):
    """GET /stats carries the process's counters: a request adds its clip
    and frames, and one style-cache lookup."""
    _, port = server
    style, audio = corpus["clips"][1]
    before = _get(port, "/stats")["counters"]
    _post(port, "/synthesize", {"audio_path": str(audio), "style_path": str(style), "seed": 3})
    after = _get(port, "/stats")["counters"]

    def added(name):
        return after.get(name, 0) - before.get(name, 0)

    assert added("batch.clips") == 1 and added("batch.frames") > 0
    assert added("style_cache.hits") + added("style_cache.misses") == 1
    assert added("batch.frames_rolled") >= added("batch.frames")


def test_concurrent_requests_coalesce(corpus, tmp_path):
    """Requests inside one batching window come out of one batched rollout.
    The drain ends when the third arrives (max_batch), not on a clock, so a
    slow handler thread on a loaded machine cannot split the batch."""
    srv = GestureServer(corpus["pipe"], max_batch=3, max_wait_ms=60_000)
    port = srv.start()
    try:
        style, audio = corpus["clips"][1]
        results = [None] * 3

        def worker(i):
            results[i] = _post(port, "/synthesize", {
                "audio_wav_b64": _b64(audio), "styles": [{"bvh_b64": _b64(style)}],
                "seed": 100 + i})

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert [r["batch_size"] for r in results] == [3, 3, 3]
        assert len({r["bvh"] for r in results}) == 3  # three seeds
        for r in results:
            _check_bvh(r["bvh"], tmp_path)
        stats = _get(port, "/stats")
        assert stats["requests_total"] == 3 and stats["batch_size_max"] == 3
    finally:
        srv.stop()


def test_validation_errors(server, corpus):
    _, port = server
    style, audio = corpus["clips"][0]
    before = _get(port, "/stats")["requests_total"]
    cases = [
        {},  # no audio
        {"audio_path": "/nonexistent.wav", "style_path": str(style)},
        {"audio_path": str(audio)},  # no style
        {"audio_path": str(audio), "styles": []},
        {"audio_path": str(audio), "styles": ["not-a-dict"]},
        {"audio_path": str(audio), "style_label": "NotAStyle"},
        {"audio_path": str(audio), "style_label": 99},  # index out of range
        {"audio_path": str(audio), "style_label": 0},  # label without first_pose
        {"audio_path": str(audio), "style_path": str(style), "blend_ratio": [0.5, 0.5]},
        {"audio_path": 12345, "style_path": str(style)},
    ]
    for payload in cases:
        code, _ = _post_code(port, "/synthesize", payload)
        assert code == 400, payload
    assert _get(port, "/stats")["requests_total"] == before


def test_bad_request_does_not_fail_cobatched_neighbour(corpus, tmp_path):
    """A corrupt style BVH passes validation and fails at synthesis; the
    valid request batched with it succeeds through the per-job retry. The
    drain ends when the second arrives (max_batch), not on a clock."""
    srv = GestureServer(corpus["pipe"], max_batch=2, max_wait_ms=60_000)
    port = srv.start()
    try:
        style, audio = corpus["clips"][0]
        corrupt = tmp_path / "corrupt.bvh"
        corrupt.write_text("HIERARCHY\nnot a real bvh\n")
        results = {}

        def send(name, style_path):
            results[name] = _post_code(port, "/synthesize", {
                "audio_path": str(audio), "style_path": str(style_path), "seed": 2})

        threads = [threading.Thread(target=send, args=a)
                   for a in (("good", style), ("bad", corrupt))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results["bad"][0] == 500
        code, good = results["good"]
        assert code == 200 and good["batch_size"] == 2
        _check_bvh(good["bvh"], tmp_path)
    finally:
        srv.stop()


def test_stream_unknown_session_404_and_bad_start_400(server):
    _, port = server
    assert _post_code(port, "/stream/push", {"session_id": "nope", "audio_f32_b64": ""})[0] == 404
    assert _post_code(port, "/stream/start", {"styles": []})[0] == 400
    assert _post_code(port, "/stream/nonsense", {})[0] == 404


def test_body_beyond_cap_gets_413(corpus):
    srv = GestureServer(corpus["pipe"], max_batch=2, max_wait_ms=10, max_body_bytes=1000)
    port = srv.start()
    try:
        code, body = _post_code(port, "/synthesize", {"audio_wav_b64": "A" * 4000,
                                                      "style_label": 0})
        assert code == 413 and "body too large" in body["error"]
        assert _post_code(port, "/stream/push", {"session_id": "x", "pad": "A" * 4000})[0] == 413
        assert _post_code(port, "/synthesize", {"style_label": 0})[0] == 400
        # a negative Content-Length answers 400 instead of reading to EOF
        with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
            s.sendall(b"POST /synthesize HTTP/1.1\r\nHost: x\r\nContent-Length: -1\r\n\r\n{}")
            assert b"400" in s.recv(64).split(b"\r\n", 1)[0]
    finally:
        srv.stop()


def test_stream_max_sessions_429(corpus):
    srv = GestureServer(corpus["pipe"], max_batch=2, max_wait_ms=10, max_sessions=1)
    port = srv.start()
    try:
        payload = {"styles": [{"bvh_b64": _b64(corpus["clips"][0][0])}]}
        _post(port, "/stream/start", payload)
        before = _get(port, "/stats")["rejected_total"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(port, "/stream/start", payload)
        assert exc.value.code == 429 and int(exc.value.headers["Retry-After"]) >= 1
        assert _get(port, "/stats")["rejected_total"] == before + 1
    finally:
        srv.stop()


def _samples(path):
    _, samples = wav.read_wavfile(path, desired_fs=16000)
    return np.asarray(samples, "<f4")


def test_stream_finish_empty_is_400_and_session_survives(server, corpus, tmp_path):
    _, port = server
    style, audio = corpus["clips"][0]
    sid = _post(port, "/stream/start", {"styles": [{"bvh_b64": _b64(style)}],
                                        "seed": 3})["session_id"]
    code, body = _post_code(port, "/stream/finish", {"session_id": sid, "bvh": True})
    assert code == 400 and "no audio" in body["error"]
    _post(port, "/stream/push", {"session_id": sid,
                                 "audio_f32_b64": base64.b64encode(_samples(audio)).decode()})
    fin = _post(port, "/stream/finish", {"session_id": sid, "bvh": True})
    assert fin["total_frames"] == NFRAMES
    _check_bvh(fin["bvh"], tmp_path)


@pytest.mark.parametrize("quantum", [1, 16])
def test_stream_http_equals_in_process_session(server, corpus, tmp_path, quantum):
    """Frames over HTTP are bit-identical to a session run in the process on
    the same pipeline, chunks and seed; the session is gone after finish."""
    srv, port = server
    style, audio = corpus["clips"][0]
    samples = _samples(audio)
    out = _post(port, "/stream/start", {"styles": [{"bvh_b64": _b64(style)}], "seed": 7,
                                        "quantum": quantum})
    sid = out["session_id"]
    chunks = [_frames(out["frames"])]
    assert chunks[0]["root_pos"].shape[0] == 1  # frame 0, the first-pose state
    for part in np.array_split(samples, 3):
        r = _post(port, "/stream/push", {"session_id": sid,
                                         "audio_f32_b64": base64.b64encode(part).decode()})
        chunks.append(_frames(r["frames"]))
    fin = _post(port, "/stream/finish", {"session_id": sid, "bvh": True})
    chunks.append(_frames(fin["frames"]))
    assert fin["total_frames"] == NFRAMES
    _check_bvh(fin["bvh"], tmp_path)
    got = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}

    sess = srv.pipe.streaming_session([(style, None)], seed=7, quantum=quantum)
    direct = [sess._collect(0)] + [sess.push(p) for p in np.array_split(samples, 3)]
    direct.append(sess.finish())
    for k in got:
        np.testing.assert_array_equal(got[k], np.concatenate([d[k] for d in direct]))
    assert _post_code(port, "/stream/push", {"session_id": sid, "audio_f32_b64": ""})[0] == 404


def test_cli_serve_builds_the_server(corpus, monkeypatch):
    served = []

    def serve_forever(self):
        served.append(self)
        self.start()

    monkeypatch.setattr(GestureServer, "serve_forever", serve_forever)
    cli.main(["-o", str(corpus["root"] / "options.json"), "--device", "cpu", "--port", "0",
              "--int8", "--b64-only", "--max-sessions", "3", "--stream-quantum", "8"])
    (srv,) = served
    try:
        assert srv.pipe.device.type == "cpu" and srv.pipe.rollout_weights == "int8"
        assert not srv.allow_paths and srv.max_sessions == 3 and srv.stream_quantum == 8
    finally:
        srv.stop()
