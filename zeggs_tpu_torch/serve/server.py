"""HTTP serving daemon: dynamic micro-batched gesture synthesis
(counterpart of `zeggs_tpu/serve/server.py`).

The reference has no serving component: its CSV mode replays clips one at
a time. One card synthesizes gesture frames far faster than realtime, so
the server's job is to keep it fed with batches while holding tail
latency. Requests that arrive while the previous batch is on the device
(or within ``max_wait_ms`` of each other) coalesce into one bucketed
batched rollout (``infer.batch.generate_batch``), giving near-batched
throughput at interactive latencies.

Design:
  * one scheduler thread owns all device work, inside
    `torch.inference_mode` (which is thread-local); HTTP handler threads
    only validate, enqueue, and wait on per-request futures, so the
    device's stream of work stays single-threaded, and no handler touches
    the card while the scheduler captures a rollout program (a CUDA graph,
    `infer/programs.py`, captured in thread-local mode on a stream of its
    own). Drains run through `generate_batch`, whose chunks are padded
    to the "pow2" batch sizes, so a few programs serve every drain. With a
    ``mesh``,
    `generate_batch` spreads a batch's rows over its devices from worker
    threads of its own and returns once all are done, so a session push
    (which runs on the pipeline's device) never overlaps a sharded
    rollout,
  * dynamic batching: after the first request of a window, drain the
    queue up to ``max_batch``, waiting at most ``max_wait_ms`` — while a
    batch is running on device, arrivals pile up and the next drain takes
    them all at once,
  * responses carry the BVH text inline (JSON), plus scheduling metadata
    (batch size, queue + synthesis latency) so clients can observe the
    batcher; GET /stats adds the process's counters
    (`utils.profiling.counters`) under ``counters``: among them
    ``programs.captures`` (a capture after warm-up stalls every queued
    request for seconds) and ``style_cache.hits`` / ``.misses``,
  * stdlib only (``http.server.ThreadingHTTPServer``): no new deps.
"""

from __future__ import annotations

import base64
import json
import shutil
import tempfile
import threading
import time
import traceback
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from queue import Empty, Full, Queue
from typing import Optional

import numpy as np
import torch

from ..infer.batch import Request, generate_batch
from ..utils import profiling


class _Stopped(Exception):
    """Admission raced with stop(): reject with 503 instead of enqueueing
    into a queue nobody will ever drain."""


def _encode_frames(frames):
    """Gesture frames -> JSON-safe dict: base64 little-endian float32
    buffers + shapes, keyed root_pos (n,3), root_rot (n,4), lpos (n,J,3),
    ltxy (n,J,2,3)."""
    return {
        "n": int(frames["root_pos"].shape[0]),
        "dtype": "float32",
        "data": {
            k: {
                "b64": base64.b64encode(
                    np.ascontiguousarray(v, np.float32).tobytes()).decode(),
                "shape": list(v.shape),
            }
            for k, v in frames.items()
        },
    }


@dataclass
class _Job:
    request: Request
    display_name: str = ""  # client-requested name (response only; the
    # filesystem always uses request.file_name = a server-issued id, so a
    # hostile or colliding client name can never shape a path)
    n_frames_hint: int = 0
    done: threading.Event = field(default_factory=threading.Event)
    bvh_text: Optional[str] = None
    error: Optional[str] = None
    t_enqueue: float = 0.0
    t_done: float = 0.0
    batch_size: int = 0
    abandoned: bool = False  # handler gave up (504): skip synthesis
    upload_paths: list = field(default_factory=list)  # b64 style/pose temps


@dataclass
class _StreamOp:
    """A streaming-session operation (start/push/finish) queued to the
    scheduler thread, which owns ALL device work — stream ops and batched
    synthesis never touch the device concurrently."""

    fn: object  # callable() -> response dict, run on the scheduler thread
    client_fault: bool = False  # errors reply 400 (start) instead of 500
    session_id: Optional[str] = None  # for fail-stop on a late abandon
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[str] = None
    abandoned: bool = False
    started: bool = False
    _state: threading.Lock = field(default_factory=threading.Lock)

    def claim_start(self):
        """Scheduler-side: atomically mark the op running. False if the
        handler already abandoned it (504 sent, nobody reads the result)."""
        with self._state:
            if self.abandoned:
                return False
            self.started = True
            return True

    def claim_abandon(self):
        """Handler-side on deadline expiry: atomically abandon the op.
        False if the scheduler already started executing it — a started
        session op MUST NOT be silently dropped (the client would retry
        and feed the same audio twice into a mutated session)."""
        with self._state:
            if self.started:
                return False
            self.abandoned = True
            return True


class _Stats:
    """Rolling serving metrics (thread-safe)."""

    def __init__(self, window=1024):
        self.lock = threading.Lock()
        self.total = 0
        self.errors = 0
        self.rejected = 0  # 429: queue full
        self.timeouts = 0  # 504: handler deadline expired
        self.latencies_ms = []  # rolling
        self.batch_sizes = []  # rolling
        self.window = window

    def record(self, latency_ms, batch_size, error=False):
        with self.lock:
            self.total += 1
            self.errors += int(error)
            self.latencies_ms.append(latency_ms)
            self.batch_sizes.append(batch_size)
            if len(self.latencies_ms) > self.window:
                self.latencies_ms = self.latencies_ms[-self.window :]
                self.batch_sizes = self.batch_sizes[-self.window :]

    def record_rejected(self):
        with self.lock:
            self.rejected += 1

    def record_timeout(self):
        with self.lock:
            self.timeouts += 1

    def snapshot(self):
        with self.lock:
            lat = np.asarray(self.latencies_ms, np.float64)
            out = {
                "requests_total": self.total,
                "errors_total": self.errors,
                "rejected_total": self.rejected,
                "timeouts_total": self.timeouts,
                "window": len(lat),
            }
            if len(lat):
                out.update(
                    latency_ms_p50=round(float(np.percentile(lat, 50)), 1),
                    latency_ms_p99=round(float(np.percentile(lat, 99)), 1),
                    batch_size_mean=round(float(np.mean(self.batch_sizes)), 2),
                    batch_size_max=int(np.max(self.batch_sizes)),
                )
            return out


class GestureServer:
    """Micro-batching synthesis server around a ``GesturePipeline``.

    Start with ``serve_forever()`` (blocking) or ``start()`` (background
    thread; returns the bound port). POST /synthesize, GET /healthz,
    GET /stats.
    """

    def __init__(self, pipe, host="127.0.0.1", port=0, max_batch=64,
                 max_wait_ms=30, bucket=512, mesh=None, max_queue=256,
                 request_timeout_s=900.0, allow_paths=None, drain_s=30.0,
                 max_sessions=16, session_ttl_s=600.0, stream_quantum=16,
                 max_body_bytes=64 << 20, max_push_s=120.0):
        """``mesh`` (`parallel.create_mesh`): the devices a batch's rows are
        split over; None runs every batch on the pipeline's device.
        ``max_queue`` bounds the scheduler queue: a burst beyond device
        throughput gets 429 + Retry-After instead of unbounded memory and
        thread growth. ``request_timeout_s`` bounds how long a handler
        waits for its batch (504 on expiry).
        ``allow_paths`` gates ``audio_path``/``bvh_path``/``first_pose``
        payload fields that read server-visible files; default: enabled
        only for loopback binds — non-loopback servers accept b64 uploads
        only, unless explicitly overridden. ``drain_s`` bounds the graceful
        drain of queued work in :meth:`stop`. ``max_body_bytes`` caps the
        request body read from any POST (413 beyond it) and ``max_push_s``
        caps the decoded audio per /stream/push (400 beyond it) — a client
        can never make the server allocate unbounded memory per request."""
        self.pipe = pipe
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.bucket = int(bucket)
        self.mesh = mesh
        self.request_timeout_s = float(request_timeout_s)
        self.drain_s = float(drain_s)
        if allow_paths is None:
            # "" binds INADDR_ANY (all interfaces) — NOT loopback
            allow_paths = host in ("127.0.0.1", "localhost", "::1")
        self.allow_paths = bool(allow_paths)
        self.stats = _Stats()
        # live streaming sessions (POST /stream/{start,push,finish}); owned
        # by the scheduler thread, GC'd after session_ttl_s of inactivity
        self.max_sessions = int(max_sessions)
        self.session_ttl_s = float(session_ttl_s)
        self.stream_quantum = int(stream_quantum)
        self.max_body_bytes = int(max_body_bytes)
        self.max_push_samples = int(
            float(max_push_s) * pipe.mel_cfg.sampling_rate)
        # _sessions is mutated from handler threads (queued-op accounting,
        # fail-stop) AND the scheduler thread (start/finish/GC): every map
        # mutation or iteration holds this lock. Session *entries* (plain
        # dicts) are only field-stamped, which is atomic in CPython.
        self._sessions_lock = threading.Lock()
        self._sessions: dict = {}
        self._queue: Queue = Queue(maxsize=int(max_queue))
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._seq = 0
        self._seq_lock = threading.Lock()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._tmp_root = Path(tempfile.mkdtemp(prefix="zeggs_serve_"))

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet access log
                pass

            def _read_json(self):
                """Read+parse the request body, bounded by max_body_bytes:
                the declared Content-Length is client-controlled, so it is
                checked BEFORE any allocation (413), and the read itself is
                capped so a lying header can't slip past the check either.
                Returns the payload dict or None (reply already sent)."""
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self._reply(400, {"error": "bad Content-Length"})
                    return None
                if length < 0:
                    # a negative length would turn rfile.read(-1) into
                    # read-until-EOF, bypassing the cap entirely
                    self._reply(400, {"error": "bad Content-Length"})
                    return None
                if length > server.max_body_bytes:
                    self._reply(413, {"error": f"body too large ({length} > "
                                      f"{server.max_body_bytes} bytes)"})
                    return None
                try:
                    body = self.rfile.read(min(length, server.max_body_bytes))
                    return json.loads(body or b"{}")
                except Exception as e:
                    self._reply(400, {"error": f"bad json: {e}"})
                    return None

            def _reply(self, code, obj, headers=()):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    dev = server.pipe.device
                    self._reply(200, {
                        "ok": True,
                        "platform": dev.type,
                        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                   else "cpu"),
                        "style_encoding_type": server.pipe.style_encoding_type,
                    })
                elif self.path == "/stats":
                    snap = server.stats.snapshot()
                    snap["live_sessions"] = len(server._sessions)
                    snap["counters"] = profiling.counters()
                    self._reply(200, snap)
                else:
                    self._reply(404, {"error": "not found"})

            def _run_op(self, fn, client_fault=False, uploads=(),
                        session_id=None):
                """Enqueue a _StreamOp and wait; same admission (429),
                deadline (504), and shutdown (503) semantics as synthesis.
                ``uploads`` are unlinked on every path that prevents the op
                from running (429/503/504) — an op that does run owns them."""
                op = _StreamOp(fn=fn, client_fault=client_fault,
                               session_id=session_id)

                def drop_uploads():
                    for p in uploads:
                        p.unlink(missing_ok=True)

                # count the op against its session BEFORE enqueueing, so GC
                # can never collect a session whose op is still queued (a
                # single long batch can exceed session_ttl_s); the
                # settle path (_settle_op) decrements exactly once for every
                # op that made it into the queue.
                server._session_op_enqueued(session_id)
                try:
                    with server._inflight_lock:
                        if server._stop.is_set():
                            raise _Stopped()
                        server._queue.put_nowait(op)
                        server._inflight += 1
                except Full:
                    server._session_op_settled(session_id)
                    drop_uploads()
                    server.stats.record_rejected()
                    self._reply(429, {"error": "queue full, retry later"},
                                headers=(("Retry-After", "1"),))
                    return
                except _Stopped:
                    # raced with stop(): the write above may have recreated
                    # the already-rmtree'd tmp root — remove it again
                    server._session_op_settled(session_id)
                    drop_uploads()
                    shutil.rmtree(server._tmp_root, ignore_errors=True)
                    self._reply(503, {"error": "server shutting down"})
                    return
                if not op.done.wait(timeout=server.request_timeout_s):
                    if op.claim_abandon():
                        # the op stays queued; the scheduler will dequeue it,
                        # see the abandon, and settle it (decrementing the
                        # session's queued count) — uploads die here though
                        drop_uploads()
                        server.stats.record_timeout()
                        self._reply(504, {"error": "stream op timed out"})
                        return
                    # the scheduler is ALREADY executing this op: dropping it
                    # now would desync the session (a client retry re-feeds
                    # consumed audio). Grant one more deadline; if even that
                    # expires, fail-stop the whole session so the corruption
                    # can never be silent.
                    if not op.done.wait(timeout=server.request_timeout_s):
                        if session_id is not None:
                            with server._sessions_lock:
                                server._sessions.pop(session_id, None)
                        server.stats.record_timeout()
                        self._reply(504, {"error": "stream op stuck; "
                                          "session terminated"})
                        return
                if op.error is not None:
                    self._reply(400 if op.client_fault else 500,
                                {"error": op.error})
                    return
                result = op.result or {}
                status = result.pop("_status", 200)
                headers = result.pop("_headers", ())
                self._reply(status, result, headers=headers)

            def do_POST(self):
                if self.path.startswith("/stream/"):
                    self._do_stream()
                    return
                if self.path != "/synthesize":
                    self._reply(404, {"error": "not found"})
                    return
                payload = self._read_json()
                if payload is None:
                    return
                if server._draining.is_set() or server._stop.is_set():
                    self._reply(503, {"error": "server shutting down"})
                    return
                try:
                    job = server._make_job(payload)
                except Exception as e:
                    # any malformed payload is the client's fault: 400,
                    # never a dropped connection or a scheduler crash
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                    return
                try:
                    with server._inflight_lock:
                        # stop() sets _stop under this same lock, so a job
                        # admitted here is guaranteed to be seen by stop()'s
                        # drain/flush — no enqueue into a dead queue
                        if server._stop.is_set():
                            raise _Stopped()
                        server._queue.put_nowait(job)
                        server._inflight += 1
                except Full:
                    # backpressure: the queue bound is the admission limit —
                    # reject instantly so a burst beyond device throughput
                    # can't grow memory or handler threads without bound
                    server._discard_job_files(job)
                    server.stats.record_rejected()
                    retry_s = max(1, int(server.max_wait_ms / 1e3 * 2) + 1)
                    self._reply(429, {"error": "queue full, retry later"},
                                headers=(("Retry-After", str(retry_s)),))
                    return
                except _Stopped:
                    # raced with stop(): the tmp root may already be gone —
                    # drop this job's uploads (and the dir _make_job may have
                    # just recreated) before answering
                    server._discard_job_files(job)
                    shutil.rmtree(server._tmp_root, ignore_errors=True)
                    self._reply(503, {"error": "server shutting down"})
                    return
                # bounded handler wait (504 on expiry): a lost job
                # (scheduler died) or a batch running past the deadline
                # still answers instead of hanging
                if not job.done.wait(timeout=server.request_timeout_s):
                    job.abandoned = True  # scheduler will skip it
                    server.stats.record_timeout()
                    server.stats.record(server.request_timeout_s * 1e3, 0,
                                        error=True)
                    self._reply(504, {"error": "synthesis timed out"})
                    return
                if job.error is not None:
                    server.stats.record(
                        (job.t_done - job.t_enqueue) * 1e3, job.batch_size, error=True
                    )
                    self._reply(500, {"error": job.error})
                    return
                latency_ms = (job.t_done - job.t_enqueue) * 1e3
                server.stats.record(latency_ms, job.batch_size)
                self._reply(200, {
                    "file_name": job.display_name,
                    "bvh": job.bvh_text,
                    "latency_ms": round(latency_ms, 1),
                    "batch_size": job.batch_size,
                })

            def _do_stream(self):
                """Live streaming over plain request/response HTTP:

                POST /stream/start  {styles|style_path|style_label,
                                     first_pose?/first_pose_bvh_b64?,
                                     temperature?, seed?, blend_ratio?,
                                     quantum?}            -> {session_id}
                POST /stream/push   {session_id, audio_f32_b64}
                                                          -> {frames}
                POST /stream/finish {session_id, bvh?}    -> {frames, bvh?}

                audio_f32_b64 is raw little-endian float32 mono PCM at the
                pipeline sampling rate (16 kHz), any chunking. frames holds
                base64 float32 arrays keyed root_pos (n,3), root_rot (n,4),
                lpos (n,J,3), ltxy (n,J,2,3) — exactly the offline frames
                (tests/test_torch_streaming.py). Sessions idle past session_ttl_s
                with no queued ops are garbage-collected."""
                payload = self._read_json()
                if payload is None:
                    return
                if server._draining.is_set() or server._stop.is_set():
                    self._reply(503, {"error": "server shutting down"})
                    return

                if self.path == "/stream/start":
                    name = server._next_name()
                    uploads = []
                    try:
                        styles = server._parse_styles(payload, name, uploads)
                        first_pose = server._parse_first_pose(
                            payload, name, uploads, styles)
                        blend_ratio = server._parse_blend_ratio(
                            payload, len(styles))
                    except Exception as e:
                        for p in uploads:
                            p.unlink(missing_ok=True)
                        self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                        return
                    self._run_op(
                        lambda: server._op_stream_start(
                            styles, first_pose, blend_ratio, payload, uploads),
                        client_fault=True, uploads=uploads,
                    )
                    return

                sid = payload.get("session_id")
                with server._sessions_lock:
                    entry = server._sessions.get(sid) if sid else None
                    if entry is not None:
                        # stamp activity at ENQUEUE; the queued-op counter
                        # (incremented in _run_op) is what actually protects
                        # a push queued behind a long batch from GC
                        entry["last"] = time.monotonic()
                if entry is None:
                    self._reply(404, {"error": f"unknown session: {sid!r}"})
                    return
                if self.path == "/stream/push":
                    try:
                        audio = np.frombuffer(
                            base64.b64decode(payload["audio_f32_b64"]),
                            dtype="<f4")
                    except Exception as e:
                        self._reply(400, {"error": f"bad audio_f32_b64: {e}"})
                        return
                    if audio.size > server.max_push_samples:
                        self._reply(400, {
                            "error": f"push too long ({audio.size} samples > "
                                     f"{server.max_push_samples}); chunk it"})
                        return
                    self._run_op(lambda: server._op_stream_push(sid, audio),
                                 session_id=sid)
                elif self.path == "/stream/finish":
                    self._run_op(lambda: server._op_stream_finish(
                        sid, want_bvh=bool(payload.get("bvh"))),
                        session_id=sid)
                else:
                    self._reply(404, {"error": "not found"})

        class _Server(ThreadingHTTPServer):
            # the default listen(5) backlog RSTs connect bursts at the
            # kernel before the handler can answer 429 — admission control
            # must happen in the application, not as dropped SYNs
            request_queue_size = 128

        self._httpd = _Server((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._scheduler = threading.Thread(target=self._run_scheduler, daemon=True)

    # -- request parsing ------------------------------------------------

    def _next_name(self):
        with self._seq_lock:
            self._seq += 1
            return f"r{self._seq:06d}"

    def _make_job(self, payload):
        """Validate a /synthesize JSON payload into a queued job.

        Payload: ``audio_path`` (server-visible file) or ``audio_wav_b64``
        (raw .wav bytes); ``styles``: list of {"bvh_path", "frames"?} /
        {"bvh_b64", "frames"?} / {"label"} entries (or shorthand
        ``style_path`` / ``style_label``); optional ``temperature``,
        ``seed``, ``first_pose`` / ``first_pose_bvh_b64``, ``blend_type``,
        ``blend_ratio``, ``file_name``. Validation failures raise
        ValueError -> HTTP 400 without touching the scheduler. Path fields
        are rejected when ``allow_paths`` is off (non-loopback default).

        The FILESYSTEM name is always a server-issued id (``r000042``):
        a client-supplied ``file_name`` is echoed back in the response but
        never shapes a path — no traversal via "../" or absolute names,
        and no output collisions between co-batched requests that picked
        the same name."""
        name = self._next_name()
        display_name = str(payload.get("file_name") or name)
        uploads = []
        try:
            return self._build_job(payload, name, display_name, uploads)
        except Exception:
            # validation failed mid-way: whatever b64 uploads were already
            # written are orphans — remove them before the 400 goes out
            for p in uploads:
                p.unlink(missing_ok=True)
            audio_upload = self._tmp_root / "uploads" / f"{name}.wav"
            audio_upload.unlink(missing_ok=True)
            raise

    def _check_path(self, p, what):
        # path payload fields read server-visible files; on a
        # non-loopback bind they are disabled unless explicitly
        # re-enabled (allow_paths=True) — b64 uploads only
        if not self.allow_paths:
            raise ValueError(
                f"{what} path inputs are disabled on this server; "
                "send *_b64 content instead")
        p = Path(p)
        if not p.is_file():
            raise ValueError(f"{what} not found: {p}")
        return p

    def _write_upload(self, b64, name, uploads, suffix):
        p = self._tmp_root / "uploads" / f"{name}_{len(uploads)}{suffix}"
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(base64.b64decode(b64))
        uploads.append(p)
        return p

    def _parse_styles(self, payload, name, uploads):
        """Resolve the style spec shared by /synthesize and /stream/start:
        ``styles`` entries {"bvh_b64"/"bvh_path", "frames"?} or {"label"},
        with ``style_path``/``style_label`` shorthands. Returns a list of
        (path, frames) tuples and/or labels."""
        raw_styles = payload.get("styles")
        if raw_styles is None:
            if payload.get("style_path"):
                raw_styles = [{"bvh_path": payload["style_path"],
                               "frames": payload.get("frames")}]
            elif payload.get("style_label") is not None:
                raw_styles = [{"label": payload["style_label"]}]
            else:
                raise ValueError("need styles / style_path / style_label")
        if not raw_styles:
            raise ValueError("styles must be non-empty")
        styles = []
        for s in raw_styles:
            if not isinstance(s, dict):
                raise ValueError(f"bad style entry: {s!r}")
            if "bvh_b64" in s:
                p = self._write_upload(s["bvh_b64"], name, uploads, ".bvh")
                frames = tuple(s["frames"]) if s.get("frames") else None
                styles.append((p, frames))
            elif "bvh_path" in s:
                p = self._check_path(s["bvh_path"], "style bvh")
                frames = tuple(s["frames"]) if s.get("frames") else None
                styles.append((p, frames))
            elif "label" in s:
                label = s["label"]
                if isinstance(label, str):
                    if label not in self.pipe.label_names:
                        raise ValueError(f"unknown label: {label}")
                elif not (isinstance(label, int)
                          and 0 <= label < len(self.pipe.label_names)):
                    raise ValueError(f"label index out of range: {label!r}")
                styles.append(label)
            else:
                raise ValueError(f"bad style entry: {s}")
        return styles

    def _parse_first_pose(self, payload, name, uploads, styles):
        first_pose = payload.get("first_pose")
        if payload.get("first_pose_bvh_b64"):
            first_pose = self._write_upload(
                payload["first_pose_bvh_b64"], name, uploads, ".bvh")
        elif first_pose is not None:
            first_pose = self._check_path(first_pose, "first_pose")
        if first_pose is None and not any(isinstance(s, tuple) for s in styles):
            raise ValueError("label styles require first_pose")
        return first_pose

    def _parse_blend_ratio(self, payload, n_styles):
        blend_ratio = payload.get("blend_ratio") or [1.0 / n_styles] * n_styles
        if len(blend_ratio) != n_styles:
            raise ValueError("blend_ratio length != styles length")
        return [float(r) for r in blend_ratio]

    def _build_job(self, payload, name, display_name, uploads):
        if payload.get("audio_wav_b64"):
            audio = self._tmp_root / "uploads" / f"{name}.wav"
            audio.parent.mkdir(parents=True, exist_ok=True)
            audio.write_bytes(base64.b64decode(payload["audio_wav_b64"]))
        elif payload.get("audio_path"):
            audio = self._check_path(payload["audio_path"], "audio_path")
        else:
            raise ValueError("need audio_path or audio_wav_b64")

        styles = self._parse_styles(payload, name, uploads)
        first_pose = self._parse_first_pose(payload, name, uploads, styles)

        blend_ratio = self._parse_blend_ratio(payload, len(styles))

        req = Request(
            audio=audio,
            styles=styles,
            file_name=name,
            temperature=float(payload.get("temperature", 1.0)),
            seed=int(payload.get("seed", 1234)),
            first_pose=first_pose,
            blend_type=str(payload.get("blend_type", "add")),
            blend_ratio=blend_ratio,
        )
        job = _Job(request=req, display_name=display_name,
                   t_enqueue=time.perf_counter(), upload_paths=uploads)
        return job

    # -- scheduler -------------------------------------------------------

    def _drain_batch(self):
        """Block for one job, then coalesce arrivals for up to
        max_wait_ms (or max_batch). While a previous batch was running,
        the queue has been filling — those all come out at once here."""
        try:
            first = self._queue.get(timeout=0.2)
        except Empty:
            return []
        jobs = [first]
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(jobs) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                jobs.append(self._queue.get(timeout=remaining))
            except Empty:
                break
        return jobs

    def _run_scheduler(self):
        # inference mode is thread-local: without it here, a session's
        # decoder chunks would build an autograd graph across pushes
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    self._run_one_batch()
                    self._gc_sessions()
                except Exception:  # keep serving even on unexpected errors
                    traceback.print_exc()

    # -- streaming sessions ------------------------------------------------

    def _session_op_enqueued(self, sid):
        """Handler-side: count a queued op against its session so GC skips
        it for as long as the op waits: a long batch ahead of a push must not
        cost the client its session."""
        if sid is None:
            return
        with self._sessions_lock:
            entry = self._sessions.get(sid)
            if entry is not None:
                entry["queued"] = entry.get("queued", 0) + 1

    def _session_op_settled(self, sid):
        """Decrement the queued-op count; called exactly once per op that
        was counted: on enqueue failure (handler), after the scheduler runs
        or skips it (_run_stream_op), or in stop()'s flush."""
        if sid is None:
            return
        with self._sessions_lock:
            entry = self._sessions.get(sid)
            if entry is not None:
                entry["queued"] = max(0, entry.get("queued", 0) - 1)
                entry["last"] = time.monotonic()

    def _gc_sessions(self):
        now = time.monotonic()
        with self._sessions_lock:
            for sid in [s for s, e in self._sessions.items()
                        if e.get("queued", 0) == 0
                        and now - e["last"] > self.session_ttl_s]:
                del self._sessions[sid]

    def _run_stream_op(self, op):
        if op.claim_start():
            try:
                op.result = op.fn()
            except Exception as e:
                op.error = f"{type(e).__name__}: {e}"
        self._session_op_settled(op.session_id)
        op.done.set()
        with self._inflight_lock:
            self._inflight -= 1

    def _op_stream_start(self, styles, first_pose, blend_ratio, payload,
                         uploads):
        try:
            if len(self._sessions) >= self.max_sessions:
                self.stats.record_rejected()
                return {"_status": 429, "_headers": (("Retry-After", "5"),),
                        "error": f"too many live sessions ({self.max_sessions})"}
            sess = self.pipe.streaming_session(
                styles, first_pose=first_pose, blend_ratio=blend_ratio,
                temperature=float(payload.get("temperature", 1.0)),
                seed=int(payload.get("seed", 1234)),
                quantum=int(payload.get("quantum", self.stream_quantum)),
            )
            sid = uuid.uuid4().hex
            with self._sessions_lock:
                self._sessions[sid] = {"sess": sess, "last": time.monotonic(),
                                       "queued": 0}
            # frame 0 (the first-pose state) is emitted at construction and
            # would otherwise never come out of a push
            return {"session_id": sid, "frames": _encode_frames(sess._collect(0))}
        finally:
            # style/pose uploads are single-use: encodings live in the session
            for p in uploads:
                p.unlink(missing_ok=True)

    def _op_stream_push(self, sid, audio):
        with self._sessions_lock:
            entry = self._sessions.get(sid)
        if entry is None:  # expired between handler check and scheduling
            return {"_status": 404, "error": f"unknown session: {sid!r}"}
        entry["last"] = time.monotonic()
        return {"frames": _encode_frames(entry["sess"].push(audio))}

    def _op_stream_finish(self, sid, want_bvh=False):
        with self._sessions_lock:
            entry = self._sessions.get(sid)
        if entry is None:
            return {"_status": 404, "error": f"unknown session: {sid!r}"}
        sess = entry["sess"]
        # finishing a stream that never received a frame's worth of audio
        # would assert inside StreamingSession.finish; the session stays
        # alive so the client can push and finish properly
        if int(round(60.0 * sess.samples_received
                     / self.pipe.mel_cfg.sampling_rate)) < 1:
            return {"_status": 400,
                    "error": "no audio pushed; stream cannot finish empty"}
        with self._sessions_lock:
            self._sessions.pop(sid, None)
        out = {"frames": _encode_frames(sess.finish()),
               "total_frames": sess.frames_emitted}
        if want_bvh:
            out_dir = self._tmp_root / f"stream_{sid}"
            try:
                sess.write_bvh(out_dir, "out")
                out["bvh"] = (out_dir / "out.bvh").read_text()
            finally:
                shutil.rmtree(out_dir, ignore_errors=True)
        return out

    def _discard_job_files(self, j):
        """Remove a job's b64 upload files without completing it (jobs
        rejected before admission: 429 queue-full, 503 stop race)."""
        uploads = self._tmp_root / "uploads"
        if j.request.audio.parent == uploads:
            j.request.audio.unlink(missing_ok=True)  # single-use
        for p in j.upload_paths:
            p.unlink(missing_ok=True)

    def _finish_job(self, j):
        self._discard_job_files(j)
        j.done.set()
        with self._inflight_lock:
            self._inflight -= 1

    def _run_one_batch(self):
        dequeued = self._drain_batch()
        # streaming ops run first, individually — the scheduler thread owns
        # all device work, so a session push never overlaps a batched rollout
        for op in [j for j in dequeued if isinstance(j, _StreamOp)]:
            self._run_stream_op(op)
        dequeued = [j for j in dequeued if not isinstance(j, _StreamOp)]
        # a handler that already replied 504 has nobody reading the result
        jobs = [j for j in dequeued if not j.abandoned]
        for j in dequeued:
            if j.abandoned:
                self._finish_job(j)
        if not jobs:
            return
        try:
            self._synthesize(jobs)
        except Exception:
            # one bad request (unreadable wav, wrong-fps style BVH, ...)
            # must not fail its co-batched neighbours: retry each job on
            # its own so only the offender reports the error
            if len(jobs) > 1:
                for j in jobs:
                    j.error = j.bvh_text = None  # cleared for the retry
                    try:
                        self._synthesize([j], batch_size=len(jobs))
                    except Exception:
                        pass  # the offender keeps its own j.error
        finally:
            for j in jobs:
                self._finish_job(j)

    def _synthesize(self, jobs, batch_size=None):
        out_dir = self._tmp_root / f"batch_{time.monotonic_ns()}"
        try:
            generate_batch(
                self.pipe, [j.request for j in jobs], out_dir,
                bucket=self.bucket, max_batch=self.max_batch, mesh=self.mesh,
            )
            for j in jobs:
                j.bvh_text = (out_dir / f"{j.request.file_name}.bvh").read_text()
        except Exception as e:
            for j in jobs:
                j.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
            now = time.perf_counter()
            for j in jobs:
                j.t_done = now
                j.batch_size = batch_size or len(jobs)

    # -- lifecycle -------------------------------------------------------

    def start(self):
        """Serve in background threads; returns the bound port."""
        self._scheduler.start()
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self.port

    def serve_forever(self):
        self._scheduler.start()
        try:
            self._httpd.serve_forever()
        finally:
            self.stop()

    def stop(self):
        """Graceful shutdown: stop admitting (503), let the scheduler drain
        queued work for up to ``drain_s``, then stop and fail whatever is
        left so no handler hangs to its full timeout."""
        self._draining.set()
        self._httpd.shutdown()
        deadline = time.perf_counter() + self.drain_s
        while time.perf_counter() < deadline:
            with self._inflight_lock:
                if self._inflight == 0:
                    break
            time.sleep(0.05)
        # set under the admission lock: every handler either observed _stop
        # (503, files discarded) or enqueued before this point, in which
        # case the flush below answers its job
        with self._inflight_lock:
            self._stop.set()
        # anything still queued past the drain deadline: answer now
        while True:
            try:
                j = self._queue.get_nowait()
            except Empty:
                break
            if isinstance(j, _StreamOp):
                # 503, not an op "error": a shutdown is the server's doing,
                # and client_fault ops must not see it as a 400
                j.result = {"_status": 503, "error": "server stopped"}
                self._session_op_settled(j.session_id)
                j.done.set()
                with self._inflight_lock:
                    self._inflight -= 1
            else:
                j.error = "server stopped"
                self._finish_job(j)
        with self._sessions_lock:
            self._sessions.clear()
        shutil.rmtree(self._tmp_root, ignore_errors=True)
