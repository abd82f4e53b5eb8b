"""Offline traffic: jobs of speech clips written to BVH by
`zeggs_tpu_torch/infer/batch.py::generate_batch`, as the CLI's ``-b`` mode
runs them, with label styles and a first pose per clip.

The mix names the clips a job, their lengths (uniform over a range), the
batching arguments, the first-pose pool and how many clips the check
samples. Every seed gets the same set of lengths (the
distribution's quantiles) and draws their order, the audio, the labels and
the first poses: so every job runs the same chunk shapes, which set-up
captures (`batch.warmup`). WAVs and BVHs live in a directory under the
run's temporary directory, removed at the end.

The window runs whole jobs back to back until ``--seconds`` have passed;
``frames_per_s`` is the frames of BVH written over the jobs' wall time.
The traced stretch is one more job. The check compares a sample of the
written BVHs, the longest line among them, with the reference.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import flops, infer_check, inputs
from benchmark.common import log, seed_of
from benchmark.reference import bvh
from benchmark.trace import span


def chunk_shapes(frame_lengths, bucket, max_batch):
    """The (T_pad, B_pad) of every chunk a job of these lengths runs under
    the "pow2" padding policy, one entry a chunk."""
    buckets = {}
    for n in frame_lengths:
        T_pad = max(bucket, -(-int(n) // bucket) * bucket)
        buckets[T_pad] = buckets.get(T_pad, 0) + 1
    out = []
    for T_pad, count in sorted(buckets.items()):
        for start in range(0, count, max_batch):
            B = min(max_batch, count - start)
            out.append((T_pad, min(max_batch, 1 << (B - 1).bit_length())))
    return out


class Run:
    def __init__(self, cell, cfg, seed, device):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.device = torch.device(device)
        self.mix = cell.mix
        self.parts = {}

    def setup(self):
        from zeggs_tpu_torch.config import Options
        from zeggs_tpu_torch.infer import batch
        from zeggs_tpu_torch.infer.generate import GesturePipeline

        self.batch = batch
        cfg, mix, ds = self.cfg, self.mix, self.cfg["dataset"]
        t = time.perf_counter()
        self.root = Path(tempfile.mkdtemp(prefix="zeggs_bench_offline_"))
        self.params = inputs.make_params(cfg, self.seed, self.device)
        self.names = inputs.skeleton(ds["njoints"])[0]
        self.stats = inputs.make_stats(cfg, self.seed)
        net_dir, data_dir = inputs.write_pipeline_files(cfg, self.params, self.stats, self.root)
        self.parts["weights_s"] = time.perf_counter() - t

        t = time.perf_counter()
        fs = cfg["audio_conf"]["sampling_rate"]
        rng = np.random.default_rng(seed_of(self.seed, 6))
        seconds = inputs.uniform_lengths(mix["lines"], mix["min_s"], mix["max_s"])
        self.wavs, self.frames = [], []
        (self.root / "wav").mkdir()
        for i, s in enumerate(rng.permutation(seconds)):
            path = self.root / "wav" / f"line_{i}.wav"
            inputs.write_wav(path, inputs.speech_like(rng, int(round(s * fs)), fs), fs)
            self.wavs.append(path)
            self.frames.append(int(round(60.0 * int(round(s * fs)) / fs)))
        (self.root / "pose").mkdir()
        self.poses = []
        for i in range(mix["first_poses"]):
            path = self.root / "pose" / f"pose_{i}.bvh"
            inputs.write_bvh(path, inputs.motion(mix["first_pose_frames"],
                                                 seed_of(self.seed, 7, i), ds["njoints"]))
            self.poses.append(path)
        self.rng = np.random.default_rng(seed_of(self.seed, 8))
        self.parts["inputs_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.pipe = GesturePipeline(net_dir, data_dir, options=Options.from_options_dict(cfg),
                                    style_encoding_type="label", device=self.device,
                                    rollout_weights="float32")
        self.parts["pipeline_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.shapes = chunk_shapes(self.frames, mix["bucket"], mix["max_batch"])
        batch.warmup(self.pipe, self.frames, bucket=mix["bucket"], max_batch=mix["max_batch"])
        # one line through every stage, in a chunk of a shape the jobs run
        longest = int(np.argmax(self.frames))
        self._job(-1, [longest])
        self.parts["warmup_s"] = time.perf_counter() - t
        self.jobs = []

    def setup_parts(self):
        return {k: round(v, 3) for k, v in self.parts.items()}

    def _requests(self, k, lines):
        from zeggs_tpu_torch.infer.batch import Request

        labels = self.cfg["dataset"]["styles"]
        order = self.rng.permutation(lines)
        return [Request(audio=self.wavs[i], styles=[labels[int(self.rng.integers(len(labels)))]],
                        file_name=f"job{k}_line{i}",
                        first_pose=self.poses[int(self.rng.integers(len(self.poses)))],
                        seed=int(self.rng.integers(2**31)))
                for i in order]

    def _job(self, k, lines=None):
        lines = range(len(self.wavs)) if lines is None else lines
        reqs = self._requests(k, lines)
        out = self.root / "out" / f"job{k}"
        self._sync()
        t0 = time.perf_counter()
        with span("generate_batch"):
            self.batch.generate_batch(self.pipe, reqs, out, bucket=self.mix["bucket"],
                                      max_batch=self.mix["max_batch"],
                                      write_workers=self.mix["write_workers"])
        self._sync()
        return reqs, out, time.perf_counter() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds):
        wall, frames, k = 0.0, 0, 0
        while wall < seconds:
            reqs, out, t = self._job(k)
            self.jobs.append((reqs, out))
            wall += t
            frames += sum(self.frames[int(r.file_name.rsplit("line", 1)[1])] for r in reqs)
            k += 1
        self.window_s, self.window_frames = wall, frames
        failed = sum(not (out / f"{r.file_name}.bvh").exists() for reqs, out in self.jobs
                     for r in reqs)
        return {"metrics": {"frames_per_s": frames / wall},
                "attempted": sum(len(r) for r, _ in self.jobs), "failed": failed}

    def traced_stretch(self):
        _, out, _ = self._job("traced")
        shutil.rmtree(out, ignore_errors=True)

    def gru_calls(self):
        """(B, calls) of the GRU-cell kernel in one job: T_pad - 1 steps a
        chunk of more than one row (a chunk of one takes the B=1 decoder
        kernel)."""
        return [(B, T - 1) for T, B in self.shapes if B > 1]

    def gru_bound_s(self):
        H = self.cfg["net_opt"]["decoder"]["nhidden"]
        return sum(n * flops.gru_cell_bound_s(B, H, H) for B, n in self.gru_calls())

    def rollout_flops(self):
        return self.window_frames * flops.rollout_flops_per_frame(self.cfg)

    def release(self):
        self.pipe = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------

    def _samples(self):
        """(request, BVH path) of the lines the check compares: a draw from
        the seed over every job of the window, the longest line first."""
        rng = np.random.default_rng(seed_of(self.seed, 9))
        flat = [(r, out) for reqs, out in self.jobs for r in reqs]
        n = min(self.mix["check_samples"], len(flat))
        longest = max(range(len(flat)), key=lambda i: self.frames[self._line(flat[i][0])])
        rest = [i for i in rng.permutation(len(flat)) if i != longest][: n - 1]
        return [flat[i] for i in [longest, *rest]]

    @staticmethod
    def _line(req):
        return int(req.file_name.rsplit("line", 1)[1])

    def _jobs_of(self, samples):
        labels = self.cfg["dataset"]["styles"]
        return [dict(audio=inputs.read_wav(r.audio), first_pose=bvh.load(r.first_pose),
                     style=labels.index(r.styles[0]), seed=r.seed) for r, _ in samples]

    def _program_poses(self, samples):
        poses = []
        for r, out in samples:
            path = out / f"{r.file_name}.bvh"
            poses.append(infer_check.bvh_text_pose(path.read_text(), self.names) if path.exists()
                         else (torch.zeros(0), torch.zeros(0)))
        return poses

    def check(self, tf32=False):
        t = time.perf_counter()
        samples = self._samples()
        prog = self._program_poses(samples)
        refr = infer_check.reference_poses(self.cfg, self.params, self.stats,
                                           self._jobs_of(samples), self.device, tf32)
        log(f"reference over {len(samples)} lines: {time.perf_counter() - t:.1f} s")
        limits = self.mix["limits"]
        return {k: {"value": v, "limit": limits[k]}
                for k, v in infer_check.worst(zip(prog, refr)).items()}

    def close(self):
        shutil.rmtree(self.root, ignore_errors=True)

    def control(self):
        """The reference in TF32 in the program's place, against the
        reference."""
        samples = self._samples()
        jobs = self._jobs_of(samples)
        low = infer_check.reference_poses(self.cfg, self.params, self.stats, jobs, self.device,
                                          tf32=True)
        refr = infer_check.reference_poses(self.cfg, self.params, self.stats, jobs, self.device)
        return infer_check.worst(zip(low, refr))
