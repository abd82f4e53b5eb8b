"""Daemon traffic: an open loop of Poisson arrivals of POST /synthesize to
`zeggs_tpu_torch/serve/server.py::GestureServer` on 127.0.0.1, at the
`cli/serve.py` defaults, with example styles.

The mix names the rate, the length distribution (as the offline jobs'),
the style-clip pool (clips of ``style_frames`` frames, a window of
``style_window`` frames each), the share of requests that upload a fresh
clip (a miss in the daemon's style cache) and the Zipf exponent by which
the others pick a pool clip (hits once cached), and how many replies the
check samples. Every seed gets the same set of lengths and of arrival gaps
(their quantiles) and draws their order, the audio, the clips and the
request seeds.

The load comes from a process of its own (`benchmark/http_client.py`);
the daemon runs in this one, on the card. ``request_p95_ms`` is the 95th
percentile over every request due in the window, each timed from when it
was due to its reply; a request refused or failed counts as missing (its
latency infinite) and goes into ``failed``. The traced stretch is the same
load over ``trace_seconds``.
"""

from __future__ import annotations

import gc
import http.client
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import infer_check, inputs
from benchmark.common import ROOT, log, seed_of
from benchmark.reference import bvh


def quantile_gaps(n, rate):
    """n inter-arrival gaps of a Poisson process of ``rate``: the
    exponential's quantiles (i + 0.5) / n."""
    return np.array([-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)])


def p95(latencies):
    return float(np.quantile(np.asarray(latencies, np.float64), 0.95))


class Run:
    def __init__(self, cell, cfg, seed, device):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.device = torch.device(device)
        self.mix = dict(cell.mix)
        self.parts = {}
        self.server = None

    def setup(self):
        from zeggs_tpu_torch.config import Options
        from zeggs_tpu_torch.infer import batch
        from zeggs_tpu_torch.infer.generate import GesturePipeline
        from zeggs_tpu_torch.serve.server import GestureServer

        cfg, mix, ds = self.cfg, self.mix, self.cfg["dataset"]
        t = time.perf_counter()
        self.root = Path(tempfile.mkdtemp(prefix="zeggs_bench_serve_"))
        self.params = inputs.make_params(cfg, self.seed, self.device)
        self.names = inputs.skeleton(ds["njoints"])[0]
        self.stats = inputs.make_stats(cfg, self.seed)
        net_dir, data_dir = inputs.write_pipeline_files(cfg, self.params, self.stats, self.root)
        self.parts["weights_s"] = time.perf_counter() - t

        t = time.perf_counter()
        fs = cfg["audio_conf"]["sampling_rate"]
        rng = np.random.default_rng(seed_of(self.seed, 6))
        seconds = inputs.lognormal_lengths(mix["audio_pool"], mix["median_s"], mix["sigma"],
                                           mix["min_s"], mix["max_s"])
        (self.root / "wav").mkdir()
        self.wavs, self.frames = [], []
        for i, s in enumerate(rng.permutation(seconds)):
            path = self.root / "wav" / f"line_{i}.wav"
            inputs.write_wav(path, inputs.speech_like(rng, int(round(s * fs)), fs), fs)
            self.wavs.append(path)
            self.frames.append(int(round(60.0 * int(round(s * fs)) / fs)))
        (self.root / "style").mkdir()
        self.clips = []
        for i in range(mix["style_pool"] + mix["upload_pool"]):
            path = self.root / "style" / f"clip_{i}.bvh"
            inputs.write_bvh(path, inputs.motion(mix["style_frames"], seed_of(self.seed, 7, i),
                                                 ds["njoints"]))
            self.clips.append(path)
        w0 = (mix["style_frames"] - mix["style_window"]) // 2
        self.style_frames = [w0, w0 + mix["style_window"]]
        self.parts["inputs_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.pipe = GesturePipeline(net_dir, data_dir, options=Options.from_options_dict(cfg),
                                    style_encoding_type=self.style_type(), device=self.device,
                                    rollout_weights="float32")
        self.parts["pipeline_s"] = time.perf_counter() - t
        t = time.perf_counter()
        # every program a drain can run: each length bucket at every pow2
        # batch, as the daemon's own warm-up plans it
        batch.warmup(self.pipe, self.frames, bucket=mix["bucket"], max_batch=mix["max_batch"],
                     all_pow2=True, style_jobs=[(mix["style_window"], 1)])
        self.server = GestureServer(self.pipe, host="127.0.0.1", port=0,
                                    max_batch=mix["max_batch"], max_wait_ms=mix["max_wait_ms"],
                                    bucket=mix["bucket"], max_queue=mix["max_queue"])
        self.port = self.server.start()
        # the style cache filled with every pool clip, as a daemon's is once
        # it has served a while, then a short load through the load process
        self.rng = np.random.default_rng(seed_of(self.seed, 8))
        shortest = int(np.argmin(self.frames))
        for clip in self.clips[: mix["style_pool"]]:
            self._post("/synthesize", {"audio_path": str(self.wavs[shortest]),
                                       "styles": [{"bvh_path": str(clip),
                                                   "frames": self.style_frames}]})
        self._load(min(2.0, mix["trace_seconds"]))
        self.parts["warmup_s"] = time.perf_counter() - t

    def style_type(self):
        return "example"

    def setup_parts(self):
        return {k: round(v, 3) for k, v in self.parts.items()}

    # -- the load ------------------------------------------------------------

    def _plan(self, seconds, rate):
        mix = self.mix
        n = max(1, int(round(seconds * rate)))
        dues = np.cumsum(self.rng.permutation(quantile_gaps(n, rate)))
        dues = dues - dues[0]
        audio = np.resize(self.rng.permutation(len(self.wavs)), n)
        # exactly round(n * share) uploads, and the pool clips at the Zipf
        # distribution's quantiles, in an order from the seed
        uploads = np.zeros(n, bool)
        uploads[: int(round(n * mix["upload_share"]))] = True
        uploads = self.rng.permutation(uploads)
        ranks = np.arange(1, mix["style_pool"] + 1, dtype=np.float64)
        cdf = np.cumsum(ranks ** -mix["zipf_s"] / np.sum(ranks ** -mix["zipf_s"]))
        m = int((~uploads).sum())
        pool = self.rng.permutation(np.searchsorted(cdf, (np.arange(m) + 0.5) / m))
        reqs, meta, j = [], [], 0
        for i in range(n):
            seed = int(self.rng.integers(2**31))
            payload = {"audio_path": str(self.wavs[audio[i]]), "temperature": 1.0, "seed": seed}
            req = {"due": float(dues[i]), "payload": payload}
            if uploads[i]:
                clip = mix["style_pool"] + int(self.rng.integers(mix["upload_pool"]))
                req["upload"] = clip - mix["style_pool"]
                req["frames"] = self.style_frames
            else:
                clip, j = int(pool[j]), j + 1
                payload["styles"] = [{"bvh_path": str(self.clips[clip]),
                                      "frames": self.style_frames}]
            reqs.append(req)
            meta.append({"audio": int(audio[i]), "clip": clip, "seed": seed})
        return reqs, meta

    def _client(self, plan):
        """Run the load process on ``plan`` -> its records."""
        plan_path, out_path = self.root / "plan.json", self.root / "replies.json"
        plan_path.write_text(json.dumps(plan))
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        proc = subprocess.Popen([sys.executable, "-m", "benchmark.http_client", str(plan_path),
                                 str(out_path)], cwd=ROOT, env=env)
        try:
            rc = proc.wait(timeout=plan["timeout"] + plan.get("span", 0) + 120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != 0:
            raise RuntimeError(f"the load process exited {rc}")
        return json.loads(out_path.read_text())

    def _post(self, path, payload):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=600)
        try:
            conn.request("POST", path, body=json.dumps(payload),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"{path}: {resp.status} {body}")
        return body

    def _load(self, seconds, keep=()):
        reqs, meta = self._plan(seconds, self.mix["rate"])
        uploads = [str(p) for p in self.clips[self.mix["style_pool"]:]]
        plan = {"port": self.port, "start": time.monotonic() + 3.0, "requests": reqs,
                "uploads": uploads, "timeout": self.mix["request_timeout_s"],
                "keep": [int(i) for i in keep], "span": seconds}
        recs = self._client(plan)
        return recs, meta

    def window(self, seconds):
        n = max(1, int(round(seconds * self.mix["rate"])))
        keep = np.random.default_rng(seed_of(self.seed, 9)).choice(
            n, min(n, self.mix["keep_replies"]), replace=False)
        recs, meta = self._load(seconds, keep=keep)
        self.recs, self.meta = recs, meta
        ok = [r for r in recs if r["status"] == 200]
        lat = [(r["done"] - r["due"]) * 1e3 if r["status"] == 200 else float("inf")
               for r in recs]
        late = max(r["sent"] - r["due"] for r in recs)
        log(f"{len(recs)} requests, {len(ok)} answered; generator at most {late * 1e3:.1f} ms "
            f"late; statuses {sorted({r['status'] for r in recs})}")
        return {"metrics": {"request_p95_ms": p95(lat)}, "attempted": len(recs),
                "failed": len(recs) - len(ok)}

    def traced_stretch(self):
        self._load(self.mix["trace_seconds"])

    def replies(self):
        return [r for r in self.recs if r["status"] == 200]

    def release(self):
        if self.server is not None:
            self.server.stop()
            self.server = None
        self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self):
        shutil.rmtree(self.root, ignore_errors=True)

    # -- the check -----------------------------------------------------------

    def _samples(self):
        """(record, its request) of the replies the check compares: of the
        kept replies (a draw from the seed) those answered, the longest
        first."""
        kept = [(r, m) for r, m in zip(self.recs, self.meta)
                if "reply" in r and r["status"] == 200]
        kept.sort(key=lambda rm: -self.frames[rm[1]["audio"]])
        return kept[: self.mix["check_samples"]]

    def _jobs_of(self, samples):
        jobs = []
        for _, m in samples:
            jobs.append(dict(audio=inputs.read_wav(self.wavs[m["audio"]]), first_pose=None,
                             style=bvh.load(self.clips[m["clip"]]), frames=self.style_frames,
                             temperature=1.0, seed=m["seed"]))
        return jobs

    def check(self, tf32=False):
        t = time.perf_counter()
        samples = self._samples()
        prog = []
        for r, _ in samples:
            text = r["reply"].get("bvh")
            prog.append(infer_check.bvh_text_pose(text, self.names) if text
                        else (torch.zeros(0), torch.zeros(0)))
        refr = infer_check.reference_poses(self.cfg, self.params, self.stats,
                                           self._jobs_of(samples), self.device, tf32)
        log(f"reference over {len(samples)} replies: {time.perf_counter() - t:.1f} s")
        limits = self.mix["limits"]
        return {k: {"value": v, "limit": limits[k]}
                for k, v in infer_check.worst(zip(prog, refr)).items()}

    def control(self):
        samples = self._samples()
        jobs = self._jobs_of(samples)
        low = infer_check.reference_poses(self.cfg, self.params, self.stats, jobs, self.device,
                                          tf32=True)
        refr = infer_check.reference_poses(self.cfg, self.params, self.stats, jobs, self.device)
        return infer_check.worst(zip(low, refr))
