"""The bench's train stage: the captured train step at full v1 width over a
device-resident corpus (counterpart of `scripts/device_train_bench.py` and
`scripts/train_step_bench.py`).

    python -m zeggs_tpu_torch.bench.train [--bf16] [--iters 10] [--turns 5] [--busy-replays 3]

A synthetic corpus at full v1 dims (`_FakeDS`: 20,000 frames, 75 joints,
window 256, examples 512 wide) is uploaded once (`data/device_dataset.py::
DeviceCorpus`); each step copies in only the window starts, example rows and
lengths of B=32 windows (example lengths ``2 * rng.integers(128, 257)``),
and `train/programs.py::TrainProgram` runs it: the first step eagerly (the
warm-up), the second captured as a CUDA graph and replayed, every later step
a replay. ``--bf16`` computes the decoder's products in bfloat16.

Reported: ``step_ms`` (the minimum of ``--iters`` replays, each closed by a
synchronize) and ``step_ms_median``, ``it_s`` and ``frames_per_s`` at the
minimum; ``build_s`` (corpus, networks, upload); ``first_exec_s`` (the
eager first step), ``capture_s`` (the capture alone) and ``compile_s`` (the
first step and the second, capture and replay: the card's counterpart of
XLA's compile and first call); ``eager_step_ms_median`` (the plain eager
step, `train.loop.make_train_step`, on a copy of the state, timed in turns
with as many replays); the graphs' pool memory and kernel counts, and the
card's busy share over ``--busy-replays`` replays (`torch.profiler`). XLA's
``compile_cache`` and ``aot*`` keys have no counterpart. At float32 a
train step launches the training rollout's kernels (``decoder_train`` in
``launches``) and none of the inference kernels, which raise under
autograd. Prints one JSON line; exits 1 if a loss is not finite.
"""

from __future__ import annotations

import copy
import ctypes
import sys
import time

import numpy as np
import torch

from ..config import TrainConfig
from ..data.device_dataset import DeviceCorpus
from ..train import loop
from ..train.programs import TrainProgram
from . import fixture as FX

BUSY_REPLAYS = 3


class _FakeDS:
    """Minimal WindowedDataset stand-in with synthetic full-dims arrays."""

    def __init__(self, n_frames=20000, J=75, window=256, example_length=256):
        rng = np.random.default_rng(0)
        q = rng.normal(size=(n_frames, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        self.arrays = {
            "audio_features": rng.normal(size=(n_frames, 81)).astype(np.float32),
            "root_pos": rng.normal(size=(n_frames, 3)).astype(np.float32),
            "root_rot": q,
            "root_vel": rng.normal(size=(n_frames, 3)).astype(np.float32) * 0.1,
            "root_vrt": rng.normal(size=(n_frames, 3)).astype(np.float32) * 0.1,
            "lpos": rng.normal(size=(n_frames, J, 3)).astype(np.float32),
            "ltxy": rng.normal(size=(n_frames, J, 2, 3)).astype(np.float32),
            "lvel": rng.normal(size=(n_frames, J, 3)).astype(np.float32) * 0.1,
            "lvrt": rng.normal(size=(n_frames, J, 3)).astype(np.float32) * 0.1,
            "gaze_pos": rng.normal(size=(n_frames, 3)).astype(np.float32),
        }
        self.window = window
        self.max_example_length = 2 * example_length
        self.window_starts = np.arange(0, n_frames - window, dtype=np.int64)
        self.window_samples = np.zeros(len(self.window_starts), np.int32)
        self.ranges_train = np.array([[0, n_frames]], np.int32)


class Step:
    """The train step of the v1 width (or the ``--tiny`` one) at a compute
    dtype: the corpus on the device, the networks, RAdam and the program."""

    def __init__(self, compute_dtype, device, tiny=False):
        train = (TrainConfig(batchsize=4, window=32, compute_dtype=compute_dtype) if tiny
                 else TrainConfig(compute_dtype=compute_dtype))
        w = FX.width(tiny, train)
        self.opts, self.device, self.batchsize = w.options, device, train.batchsize
        self.ds = (_FakeDS(2000, w.njoints, 32, 32) if tiny else _FakeDS())
        self.corpus = DeviceCorpus(self.ds, device)
        self.stats = FX._stats(w.pose_in, w.pose_out)
        self.parents = [-1] + list(range(w.njoints - 1))
        self.nets = loop.init_networks(w.options, w.dims, nlabels=19, seed=0, device=device)
        self.optimizer = loop.make_optimizer(w.options, self.nets)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(0)
        self.program = TrainProgram(
            loop.make_loss_fn(w.options, self.stats, self.parents, FX.DT), self.nets,
            self.optimizer, self.generator, self.corpus)
        self.rng = np.random.default_rng(0)

    def draw(self):
        """One step's inputs: B window starts, example rows and lengths."""
        window = self.ds.window
        idx = self.rng.integers(0, len(self.ds.window_starts), size=self.batchsize)
        starts, ex_idx, ex_len = self.corpus.sample_indices(
            idx, 2 * self.rng.integers(window // 2, window + 1))
        return {"window_starts": starts, "ex_idx": ex_idx, "ex_lengths": ex_len}

    def eager(self):
        """The plain eager step (`loop.make_train_step`) on a copy of the
        networks, RAdam state and generator -> step(inputs, iteration)."""
        nets = copy.deepcopy(self.nets)
        optimizer, plain = loop.make_train_step(self.opts, self.stats, self.parents, FX.DT, nets)
        optimizer.load_state(*self.optimizer.state())
        generator = torch.Generator(device=self.device)
        generator.set_state(self.generator.get_state())

        def step(inputs, iteration):
            batch = self.corpus.gather_batch(inputs["window_starts"], inputs["ex_idx"],
                                             inputs["ex_lengths"])
            return plain(batch, iteration, generator)

        return step


def graph_kernels(graph):
    """(kernel nodes, all nodes) of a CUDA graph kept with its graph
    (``keep_graph=True``), read through libcuda's `cuGraphGetNodes` and
    `cuGraphNodeGetType`."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphGetNodes.restype = ctypes.c_int
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphNodeGetType.restype = ctypes.c_int
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(0), 0
    for node in nodes:
        cuda.cuGraphNodeGetType(node, ctypes.byref(kind))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels, n.value


def device_events(prof):
    """(name, microseconds) of every event the card ran under the
    `torch.profiler.profile` ``prof``, read from the profiler's raw events:
    its per-event Python objects, for the ~120k kernels of a train step's
    replay, cost tens of seconds."""
    from torch.autograd import DeviceType

    return [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def busy_share(step: Step, first_iteration, n_replays=BUSY_REPLAYS):
    """The card's busy share over ``n_replays`` replays: the time of the
    events it ran (`torch.profiler`) over the host's wall time -> (share,
    wall ms)."""
    replays = [step.draw() for _ in range(n_replays)]
    torch.cuda.synchronize(step.device)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i, inputs in enumerate(replays):
            step.program.run(inputs, first_iteration + i)
        torch.cuda.synchronize(step.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return sum(us for _, us in device_events(prof)) / 1e3 / wall_ms, wall_ms


def run(compute_dtype, device, iters, turns, tiny=False, busy_replays=BUSY_REPLAYS):
    def timed(fn):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss = fn()["total_loss"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0, float(loss)

    t0 = time.perf_counter()
    step = Step(compute_dtype, device, tiny)
    t_build = time.perf_counter() - t0
    FX.log(f"build: {t_build:.1f}s; the first step (eager), then the capture")
    counts = FX.PhaseCounts()
    program, losses = step.program, []
    t_first, loss = timed(lambda: program.run(step.draw(), 0))
    losses.append(loss)
    t_capture_step, loss = timed(lambda: program.run(step.draw(), 1))
    losses.append(loss)
    FX.log(f"first step {t_first:.1f}s, capture and first replay {t_capture_step:.1f}s "
           f"(capture {program.capture_seconds:.1f}s), loss {loss:.4f}")
    it = 2
    ts = []
    for _ in range(iters):
        t, loss = timed(lambda: program.run(step.draw(), it))
        ts.append(t)
        losses.append(loss)
        it += 1
    eager, eager_ts, turn_ts = step.eager(), [], []
    for _ in range(turns):
        inputs = step.draw()
        t, loss = timed(lambda: program.run(inputs, it))
        turn_ts.append(t)
        losses.append(loss)
        t, loss = timed(lambda: eager(inputs, it))
        eager_ts.append(t)
        losses.append(loss)
        it += 1
    del eager
    counts.close("steps")
    t0 = time.perf_counter()
    share, busy_wall_ms = (busy_share(step, it, busy_replays) if device.type == "cuda" else (None, None))
    kernels = [graph_kernels(g)[0] for g in program.graphs]
    FX.log(f"replays and turns done; busy share and graph kernels in "
           f"{time.perf_counter() - t0:.1f}s")
    t = float(np.min(ts))
    t_med = float(np.median(ts))
    FX.log(f"train step ({compute_dtype}): {t * 1e3:.1f} ms (median {t_med * 1e3:.1f}) -> "
           f"{1 / t:.1f} it/s; eager median {np.median(eager_ts) * 1e3:.1f} ms in turns")
    return {
        "step_ms": round(t * 1e3, 3),
        "step_ms_median": round(t_med * 1e3, 3),
        "step_ms_n": len(ts),
        "it_s": round(1.0 / t, 3),
        "frames_per_s": round(step.batchsize * step.ds.window / t, 1),
        "build_s": round(t_build, 1),
        "compile_s": round(t_first + t_capture_step, 2),
        "first_exec_s": round(t_first, 2),
        "capture_s": round(program.capture_seconds, 2),
        "graph_pool_mib": round(program.graph_bytes / 2**20, 1),
        "graph_kernels": kernels,
        "eager_step_ms_median": round(float(np.median(eager_ts)) * 1e3, 3),
        "eager_step_ms_n": len(eager_ts),
        "turns_step_ms_median": round(float(np.median(turn_ts)) * 1e3, 3),
        "busy_share": share,
        "busy_share_n": busy_replays if share is not None else 0,
        "busy_wall_ms": busy_wall_ms,
        "compute_dtype": compute_dtype,
        "batch": step.batchsize, "window": step.ds.window,
        "losses_finite": bool(np.all(np.isfinite(losses))),
        "launches": counts.total, "device": FX.device_summary(device),
    }


def main(argv=None):
    ap = FX.stage_parser(__doc__.splitlines()[0])
    ap.add_argument("--bf16", action="store_true", help="bfloat16 decoder products")
    ap.add_argument("--iters", type=int, default=10, help="timed replays")
    ap.add_argument("--turns", type=int, default=5,
                    help="replays and eager steps timed in turns")
    ap.add_argument("--busy-replays", type=int, default=BUSY_REPLAYS,
                    help="replays profiled for the card's busy share")
    args, device = FX.parse_stage_args(ap, argv)
    result = run("bfloat16" if args.bf16 else "float32", device, args.iters, args.turns,
                 args.tiny, args.busy_replays)
    FX.emit(result)
    return 0 if result["losses_finite"] else 1


if __name__ == "__main__":
    sys.exit(main())
