"""What the profilers share: their arguments, the seeded inputs of the
training-side scripts, timing and CUDA-graph capture.

A JAX profiler times `jax.jit` programs: host clock around a call and
`block_until_ready`. Its counterparts here time each section eagerly and
as a CUDA-graph replay (the counterpart of a compiled program on a card):
the median of ``--reps`` calls after warm-up, each on the host clock closed
by `torch.cuda.synchronize`, with the CUDA-event time of the same calls
beside it, and each graph's kernel count. A capture that fails raises:
no section is reported eager in place of graphed. On the CPU (``--device
cpu``, a rehearsal) only the eager times are taken.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..bench import fixture as FX
from ..bench.train import graph_kernels
from ..ops.kernels import gru_cell as GC

WARMUP = 2
STEP_WARMUP = 2  # a TrainProgram's untimed runs: the eager first step, then the capture


def parser(description, sections=None, reps=10):
    """A profiler's arguments: ``--device`` (the card unless the caller asks
    for the CPU), ``--tiny`` (8 joints and narrow widths; CPU only),
    ``--reps`` and, with ``sections``, the sections to run (several may be
    given; the first is the default)."""
    ap = FX.stage_parser(description)
    ap.add_argument("--reps", type=int, default=reps, help="timed calls a section")
    if sections:
        ap.add_argument("which", nargs="*", choices=sections,
                        help=f"the sections to run (default: {sections[0]})")
        ap.set_defaults(default_section=sections[0])
    return ap


def parse(ap, argv=None):
    """-> (args, device); ``--tiny`` off the CPU is refused and a missing card
    raises (`bench.fixture.parse_stage_args`)."""
    args, device = FX.parse_stage_args(ap, argv)
    if getattr(args, "which", None) == []:
        args.which = [args.default_section]
    return args, device


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, reps, warmup=WARMUP):
    """``warmup`` untimed calls of ``fn``, then ``reps`` calls, each closed
    by a synchronize -> {"host_ms": median, "device_ms": median of the
    CUDA-event time of each call (None on the CPU), "n": reps}."""
    for _ in range(warmup):
        fn()
    sync(device)
    host, dev = [], []
    for _ in range(reps):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            host.append(time.perf_counter() - t0)
            dev.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
    return {"host_ms": float(np.median(host)) * 1e3,
            "device_ms": float(np.median(dev)) if dev else None, "n": reps}


class Graphed:
    """``fn`` captured as one CUDA graph on ``device``: one eager call on a
    side stream first (loading its kernels and workspaces), then the
    capture, which raises if ``fn`` cannot be captured. ``generator``: a
    `torch.Generator` on the card that ``fn`` draws from, registered with
    the graph. Calling the object replays the graph and returns ``fn``'s
    outputs of the capture (overwritten by every replay); each replay
    counts the GRU-cell launches it captured. ``kernels``: the graph's
    kernel nodes."""

    def __init__(self, fn, device, what, generator=None):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.synchronize(device)
        captured = GC.captured_launches()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if generator is not None:
            graph.register_generator_state(generator)
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.outs = fn()
            except Exception as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated: the error above says why
                raise RuntimeError(f"capturing {what} on {device} failed") from e
            graph.capture_end()
        graph.instantiate()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = graph
        self.gru_launches = GC.captured_launches() - captured
        self.kernels = graph_kernels(graph)[0]

    def __call__(self):
        self.graph.replay()
        GC.count_replay(self.gru_launches)
        return self.outs


def section(name, fn, device, reps, generator=None):
    """Time ``fn`` eagerly and, on a card, as a graph replay; print one line
    -> {"eager": timing, "graphed": timing or None, "kernels": graph kernels
    or None}."""
    eager = timed(fn, device, reps)
    graphed = kernels = None
    if device.type == "cuda":
        g = Graphed(fn, device, name, generator)
        graphed, kernels = timed(g, device, reps), g.kernels
        del g
    print(f"{name}: {line(eager, graphed, kernels)}", flush=True)
    return {"eager": eager, "graphed": graphed, "kernels": kernels}


def line(eager, graphed=None, kernels=None):
    """One section's times: eager and graphed, host and device."""

    def ms(t):
        dev = "" if t["device_ms"] is None else f" (device {t['device_ms']:.3f} ms)"
        return f"{t['host_ms']:.3f} ms{dev}"

    text = f"eager {ms(eager)}"
    if graphed is not None:
        text += f" | graphed {ms(graphed)}, {kernels} kernels"
    return text


def step_variants(eager_label, replay_label, opts, w, stats, parents, batch_np, device, reps):
    """The whole train step on one batch (numpy) at ``opts``, each form from
    the seed-0 networks of width ``w``: the eager plain step
    (`train/loop.py::make_train_step`), then the `TrainProgram` replay; one
    line each -> {"eager", "replay": timings, "kernels": the replayed
    graph's}."""
    from ..train import loop
    from ..train.programs import TrainProgram

    def generator():
        g = torch.Generator(device=device)
        g.manual_seed(0)
        return g

    batch = on(device, batch_np)
    nets = loop.init_networks(opts, w.dims, nlabels=19, seed=0, device=device)
    _, step = loop.make_train_step(opts, stats, parents, FX.DT, nets)
    gen, it = generator(), iter(range(10**9))
    eager = timed(lambda: step(batch, float(next(it)), gen), device, reps, warmup=1)
    print(f"{eager_label}: {line(eager)}", flush=True)
    del nets, step

    nets = loop.init_networks(opts, w.dims, nlabels=19, seed=0, device=device)
    program = TrainProgram(loop.make_loss_fn(opts, stats, parents, FX.DT), nets,
                           loop.make_optimizer(opts, nets), generator())
    it = iter(range(10**9))
    replay = timed(lambda: program.run(batch_np, next(it)), device, reps, warmup=STEP_WARMUP)
    kernels = graph_kernels(program.graphs[0])[0] if program.graphs else None
    print(f"{replay_label}: {line(replay)}"
          + (f", {kernels} kernels" if kernels is not None else " (eager on the CPU)"),
          flush=True)
    return {"eager": eager, "replay": replay, "kernels": kernels}


def cell_weights(dec):
    """The decoder cell's product weights, read once a step: layer0, both
    GRUs' input and hidden weights, and the output layer."""
    c = dec.cell
    return sum(t.numel() for t in (c.layer0.weight, c.gru0.weight_ih, c.gru0.weight_hh,
                                   c.gru1.weight_ih, c.gru1.weight_hh, c.out.weight))


def pose_targets(rng, B, T, J):
    """The loss and grad profilers' module-level draws, in
    `scripts/loss_profile.py`'s order: unit quaternions q, then the eight
    pose trajectories (root_rot is q) and the gaze -> (q, W, gaze) as numpy
    float32 arrays."""
    q = rng.normal(size=(B, T, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    W = {
        "root_pos": rng.normal(size=(B, T, 3)).astype(np.float32),
        "root_rot": q,
        "root_vel": rng.normal(size=(B, T, 3)).astype(np.float32),
        "root_vrt": rng.normal(size=(B, T, 3)).astype(np.float32),
        "lpos": rng.normal(size=(B, T, J, 3)).astype(np.float32),
        "ltxy": rng.normal(size=(B, T, J, 2, 3)).astype(np.float32),
        "lvel": rng.normal(size=(B, T, J, 3)).astype(np.float32),
        "lvrt": rng.normal(size=(B, T, J, 3)).astype(np.float32),
    }
    gaze = rng.normal(size=(B, T, 3)).astype(np.float32)
    return q, W, gaze


def encodings(rng, B, T, net):
    """The speech and style encodings the scripts draw after the targets
    (64 wide each at v1): (B, T, speech size) then (B, T, style size),
    numpy float32."""
    return (rng.normal(size=(B, T, net.speech_encoder.speech_encoding_size)).astype(np.float32),
            rng.normal(size=(B, T, net.style_encoder.style_encoding_size)).astype(np.float32))


def shapes(tiny):
    """(B, T, J, width) of a training-side profiler: 32 x 256 frames at the
    v1 width, or the ``--tiny`` rehearsal's 4 x 32 at 8 joints."""
    w = FX.width(tiny)
    return (4, 32, w.njoints, w) if tiny else (32, 256, w.njoints, w)


def on(device, arrays):
    """numpy arrays (a dict or a tuple) -> tensors on ``device``."""
    if isinstance(arrays, dict):
        return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    return tuple(torch.as_tensor(v, device=device) for v in arrays)


def launches_since(before):
    """Each kernel's launches since the reading ``before``
    (`bench.fixture.read_counts`), without resetting the counters."""
    return {k: n - before[k] for k, n in FX.read_counts().items()}
