"""Live-stream traffic: concurrent sessions of the daemon's
/stream/start|push|finish (`zeggs_tpu_torch/serve/server.py` over
`infer/streaming.py::StreamingSession`), each with a label style and a
first pose, at the daemon's quantum of 16.

The mix names the number of sessions, the push length and period, the
first-pose pool and how many sessions the check samples. Each session
pushes ``push_s`` of speech-like audio every ``period_s``, due on a fixed
schedule; the sessions' starts are spread evenly over one period. The
sessions start (and a warm-up session captures the programs a push runs)
in set-up. ``push_p95_ms`` is the 95th percentile over every push of every
session in the window, each timed from when its audio was due to its
reply; a push refused or failed counts as missing.

The check: the frames a sampled session received (frame 0 from its start,
then every push's) against the reference's offline frames for the audio it
pushed, at the session's fixed gain of 1 (no loudness normalisation),
which the session emits up to float reassociation.
"""

from __future__ import annotations

import base64
import math
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from benchmark import inputs
from benchmark.common import log, seed_of
from benchmark.reference import bvh, model
from benchmark.reference.precision import precision
from benchmark.traffic.open_loop_http import Run as _HttpRun
from benchmark.traffic.open_loop_http import p95

KEYS = ("root_pos", "root_rot", "lpos", "ltxy")


def decode_frames(frames):
    """A reply's frames -> {key: (n, ...) float32 array}."""
    return {k: np.frombuffer(base64.b64decode(v["b64"]), "<f4").reshape(v["shape"])
            for k, v in frames["data"].items()}


class Run(_HttpRun):
    def setup(self):
        from zeggs_tpu_torch.config import Options
        from zeggs_tpu_torch.infer.generate import GesturePipeline
        from zeggs_tpu_torch.serve.server import GestureServer

        cfg, mix, ds = self.cfg, self.mix, self.cfg["dataset"]
        t = time.perf_counter()
        self.root = Path(tempfile.mkdtemp(prefix="zeggs_bench_stream_"))
        self.params = inputs.make_params(cfg, self.seed, self.device)
        self.stats = inputs.make_stats(cfg, self.seed)
        net_dir, data_dir = inputs.write_pipeline_files(cfg, self.params, self.stats, self.root)
        self.parts["weights_s"] = time.perf_counter() - t

        t = time.perf_counter()
        (self.root / "pose").mkdir()
        self.poses = []
        for i in range(mix["first_poses"]):
            path = self.root / "pose" / f"pose_{i}.bvh"
            inputs.write_bvh(path, inputs.motion(mix["first_pose_frames"],
                                                 seed_of(self.seed, 7, i), ds["njoints"]))
            self.poses.append(path)
        self.rng = np.random.default_rng(seed_of(self.seed, 8))
        self.fs = cfg["audio_conf"]["sampling_rate"]
        self.push_n = int(round(mix["push_s"] * self.fs))
        self.parts["inputs_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.pipe = GesturePipeline(net_dir, data_dir, options=Options.from_options_dict(cfg),
                                    style_encoding_type="label", device=self.device,
                                    rollout_weights="float32")
        self.server = GestureServer(self.pipe, host="127.0.0.1", port=0,
                                    max_sessions=mix["max_sessions"],
                                    stream_quantum=mix["quantum"])
        self.port = self.server.start()
        self.parts["pipeline_s"] = time.perf_counter() - t

        t = time.perf_counter()
        # a warm-up session: every program a push and a finish run
        warm = self._start()
        rng = np.random.default_rng(seed_of(self.seed, 10))
        for _ in range(mix["warm_pushes"]):
            self._post("/stream/push", {"session_id": warm["session_id"], "audio_f32_b64":
                                        self._b64(inputs.speech_like(rng, self.push_n))})
        self._post("/stream/finish", {"session_id": warm["session_id"]})
        self.sessions = [self._start() for _ in range(mix["sessions"])]
        self.active = len(self.sessions)  # the sessions the load drives
        self.audio = [[] for _ in self.sessions]
        self.parts["sessions_s"] = time.perf_counter() - t
        self.t_load = 0.0  # seconds of pushes scheduled so far

    @staticmethod
    def _b64(samples):
        return base64.b64encode(np.ascontiguousarray(samples, "<f4").tobytes()).decode()

    def _start(self):
        labels = self.cfg["dataset"]["styles"]
        label = int(self.rng.integers(len(labels)))
        pose = int(self.rng.integers(len(self.poses)))
        reply = self._post("/stream/start", {"style_label": labels[label],
                                              "first_pose": str(self.poses[pose]),
                                              "quantum": self.mix["quantum"]})
        return {"session_id": reply["session_id"], "label": label, "pose": pose,
                "frames": [decode_frames(reply["frames"])]}

    def _load(self, seconds, keep=()):
        """Every session's pushes due in the next ``seconds`` of its
        schedule -> the load process's records, a list a session."""
        mix, N = self.mix, self.active
        n_push = max(1, int(math.floor(seconds / mix["period_s"])))
        rng = np.random.default_rng(seed_of(self.seed, 11, int(self.t_load * 1000)))
        plan_sessions = []
        for s, sess in enumerate(self.sessions[:N]):
            pushes = []
            for j in range(n_push):
                audio = inputs.speech_like(rng, self.push_n, self.fs)
                self.audio[s].append(audio)
                pushes.append({"due": s * mix["period_s"] / N + j * mix["period_s"],
                               "audio": self._b64(audio)})
            plan_sessions.append({"session_id": sess["session_id"], "pushes": pushes})
        plan = {"port": self.port, "start": time.monotonic() + 3.0, "sessions": plan_sessions,
                "timeout": mix["request_timeout_s"], "keep": list(keep),
                "span": n_push * mix["period_s"]}
        self.t_load += n_push * mix["period_s"]
        out = self._client(plan)
        for s in keep:
            for r in out[s]:
                if r["status"] == 200:
                    self.sessions[s]["frames"].append(decode_frames(r["reply"]["frames"]))
                else:
                    self.sessions[s]["broken"] = True
        return out

    def window(self, seconds):
        rng = np.random.default_rng(seed_of(self.seed, 9))
        self.kept = sorted(rng.choice(self.active, min(self.active, self.mix["check_sessions"]),
                                      replace=False).tolist())
        out = self._load(seconds, keep=self.kept)
        self._pushes_in_window = len(self.audio[0])
        recs = [r for sess in out for r in sess]
        lat = [(r["done"] - r["due"]) * 1e3 if r["status"] == 200 else float("inf")
               for r in recs]
        ok = sum(r["status"] == 200 for r in recs)
        late = max(r["sent"] - r["due"] for r in recs)
        log(f"{len(recs)} pushes, {ok} answered; generator at most {late * 1e3:.1f} ms late; "
            f"within a period: {sum(x <= self.mix['period_s'] * 1e3 for x in lat)}")
        self.recs = recs
        return {"metrics": {"push_p95_ms": p95(lat)}, "attempted": len(recs),
                "failed": len(recs) - ok}

    def traced_stretch(self):
        self._load(self.mix["trace_seconds"])

    # -- the check -----------------------------------------------------------

    def _pairs(self, tf32=False):
        """(received frames, the reference's) of each kept session."""
        nets = model.load(model.build_networks(self.cfg, self.device), self.params)
        s = inputs.stats_on(self.stats, self.device)
        dt = 1.0 / self.cfg["dataset"]["fps"]
        pairs = []
        with precision(tf32):
            for k in self.kept:
                sess = self.sessions[k]
                audio = np.concatenate(self.audio[k][: self._pushes_in_window])
                ref = model.infer(self.cfg, nets, s, dt, audio, bvh.load(self.poses[sess["pose"]]),
                                  sess["label"], normalize=False, device=self.device)
                got = None
                if not sess.get("broken"):
                    got = {key: np.concatenate([f[key] for f in sess["frames"]]) for key in KEYS}
                pairs.append((got, {key: ref[key].cpu().numpy() for key in KEYS}))
        return pairs

    @staticmethod
    def _gaps(pairs):
        rot = pos = 0.0
        for got, ref in pairs:
            if got is None or len(got["ltxy"]) > len(ref["ltxy"]) or len(got["ltxy"]) < 2:
                return {"rot_gap": float("inf"), "pos_gap": float("inf")}
            n = len(got["ltxy"])
            r = float(np.max(np.abs(got["ltxy"] - ref["ltxy"][:n])))
            p = float(np.max(np.abs(got["root_pos"] - ref["root_pos"][:n])))
            rot = max(rot, r if np.isfinite(r) else float("inf"))
            pos = max(pos, p if np.isfinite(p) else float("inf"))
        return {"rot_gap": rot, "pos_gap": pos}

    def check(self, tf32=False):
        t = time.perf_counter()
        pairs = self._pairs(tf32)
        log(f"reference over {len(pairs)} sessions: {time.perf_counter() - t:.1f} s; frames "
            f"received {[None if g is None else len(g['ltxy']) for g, _ in pairs]}")
        limits = self.mix["limits"]
        return {k: {"value": v, "limit": limits[k]} for k, v in self._gaps(pairs).items()}

    def control(self):
        low = [(l_ref, ref) for (_, l_ref), (_, ref) in zip(self._pairs(True), self._pairs())]
        return self._gaps(low)

    def close(self):
        shutil.rmtree(self.root, ignore_errors=True)
