"""Rollout programs: the decoder's batched and streamed chunks replayed from
CUDA graphs (counterpart of `zeggs_tpu`'s compiled rollout programs,
`infer/generate.py::_rollout_fn` and the streaming session's `_dec_fn`).

`zeggs_tpu` runs every batched rollout and every streamed decoder chunk as
a jitted program kept in a cache by shape. A CUDA graph is the PyTorch
counterpart on a card: fixed shapes and addresses, captured once, replayed
with one launch. A `RolloutProgram` is one graph of ``steps`` decoder steps
of the decoder's cell, ``normal`` or ``film``, for B rows
(`models.decoder.chunk_step`, GRU1 through the GRU-cell kernel), with
static buffers for its inputs (the carry, and ``steps`` columns of the gaze
and of each tensor the cell's conditioning hoists: the speech/style
products ``pre_l0`` / ``pre_g0``, and for ``film`` the style's gammas and
betas) and for its outputs (root_pos, root_rot, lpos, ltxy of each step).
`ProgramCache.rollout_chunk` runs n steps as a ladder of grains, ``n //
16`` replays of the 16-step program and then the 4- and 1-step ones for
the rest (the streaming session's decoder ladder), so a length needs at
most three graphs for each B. The conditioning is computed once for the
whole chunk (span ``zeggs:program.conditioning``), as `rollout_chunk`
computes it, and copied in a grain at a time: a replayed chunk equals the
eager one bit for bit. Counters: ``programs.rollout_steps``, the decoder
steps run (each replay adds its grain), and ``programs.rollout_device_s``,
the card's time from before a chunk's first replay to after its last
(two CUDA events on the stream the replays run on), added once the events
have passed, so it waits for nothing (`ProgramCache.settle`).

A batched chunk also runs its output stage in a graph, as `zeggs_tpu`'s
``_rollout_fn`` does inside its jitted program (`output_stage`: the joint
rotations become quaternions and the four trajectories are cast to the
pipeline's transfer dtype). A `FinishProgram` is one graph of that stage
over a whole chunk of B rows and T frames, replayed once after the
chunk's grains. `infer.batch.generate_batch` then replays one more, of the
`bake` stage over the stage's outputs: the BVH's channels (re-anchoring,
the root baked into joint 0, Euler degrees, in float32), which every other
caller computes on the host (`GesturePipeline.write_result`). After the
last of a chunk's graphs only copies run on the card. Streaming sessions,
sample synthesis and the evaluation keep the step's rot6d output.

A program is keyed by (device, slot, B, steps, int8). The slot keeps
callers that run at once apart: each block of a mesh (`infer/batch.py`)
has its own, and streaming sessions share ``"stream"``. A finish program
is keyed by (device, B, T, transfer dtype) alone, and a bake program by
(device, B, T, the dtype it reads), since each of their runs copies its
inputs in and its outputs out under the device's lock; the finish and bake
programs of a cache share one memory pool (their intermediates), as their
replays never overlap.

Captures run on one high-priority stream a device, in ``thread_local``
capture mode, so that other threads keep working on the card (a mesh's
other block, a daemon's handler threads) while one thread captures. Each
capture first runs one eager step on that stream (loading every kernel and
the products' workspace before the capture); its GRU-cell launch counts as
a launch. The graphs that one thread captures share its cuBLAS workspace
on the capture stream, so the graph work of a device is serialised: one
lock a device orders the captures and the runs' copies and replays on the
host, and one event a device orders them on the card, whatever stream
each caller runs on. A run holds the lock only while it enqueues, so one
caller enqueues while the card runs another's replays. Each replay counts
what its graph captured (`utils.profiling.replayed`). A capture or
replay that fails raises: there is no eager fall-back on a card.

On the CPU a program runs its steps eagerly and a finish program its stage
(`output_stage` or `bake`): the plain versions, which the tests hold to
`models.decoder.rollout_chunk`, `decoder.rollout` and `utils.write_bvh`.
"""

from __future__ import annotations

import functools
import threading
import time

import torch

from ..models import decoder
from ..ops import quat, xform
from ..utils import bvh_channels, profiling

#: the grains a chunk is cut into, largest first (JAX's decoder grain of 16
#: and the streaming ladder's 4 and 1)
GRAINS = (16, 4, 1)
#: the pose-state entries a chunk emits: root_pos, root_rot, lpos, ltxy
OUTPUTS = (0, 1, 4, 5)
_STATS = ("anim_input_mean", "anim_input_std", "anim_output_mean", "anim_output_std")


def ladder(n):
    """The grains that cover ``n`` decoder steps, as
    `ProgramCache.rollout_chunk` replays them: (grain, replays) pairs,
    largest grain first."""
    t = 0
    while t < n:
        grain = next(g for g in GRAINS if g <= n - t)
        reps = (n - t) // grain
        yield grain, reps
        t += reps * grain


def ladder_programs(lengths):
    """How many rollout programs `ProgramCache.rollout_chunk` captures for
    chunks of ``lengths`` decoder steps of one batch size: one a grain that
    some chunk's ladder uses."""
    return len({grain for n in lengths for grain, _ in ladder(n)})


def with_quaternions(out):
    """(root_pos, root_rot, lpos, ltxy) -> (root_pos, root_rot, lpos, lrot),
    joint rotations as quaternions."""
    return tuple(out[:3]) + (quat.from_xform(xform.orthogonalize_from_xy(out[3])),)


def output_stage(out, dtype):
    """A rollout's output stage (`zeggs_tpu`'s ``_rollout_fn`` after its
    scan): `with_quaternions`, then every trajectory cast to ``dtype``, the
    transfer dtype of the device-to-host copies."""
    return tuple(t.to(dtype) for t in with_quaternions(out))


def bake(out):
    """A rollout's (root_pos, root_rot, lpos, lrot) (B, T, ...), in the
    transfer dtype, -> its BVH channels as `GesturePipeline.write_result`
    writes them (`utils.bvh_channels`, re-anchored to the origin and the
    identity rotation): (positions, Euler degrees in order "zyx"), float32
    (B, T, J, 3)."""
    return bvh_channels(*out, reanchor=True)


class DeviceSite:
    """A device's capture stream, and the lock and event that order every
    capture and replay on the device (see the module's docstring), and the
    stream that copies rollout outputs to the host (`infer.batch._pull`),
    which takes neither. The capture stream comes from the high-priority
    pool, which no other code of the port draws from, so no other thread's
    work can land on it while it captures."""

    def __init__(self, device):
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()  # the end of the device's last graph work
        self.device = device
        self._stream = self._copy_stream = None

    @property
    def stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device, priority=-1)
        return self._stream

    @property
    def copy_stream(self):
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    def capture(self, warm_up, body, what, pool=None):
        """``warm_up()`` eagerly, then ``body()`` captured as a CUDA graph
        (into ``pool``, or a pool of its own), both on the capture stream
        and after the device's last graph work -> (graph, body's outputs,
        the counts captured (`utils.profiling.captured`), bytes the capture
        reserved, seconds). A failed capture raises. Counts one
        ``programs.captures``."""
        profiling.count("programs.captures")
        with profiling.annotate("zeggs:program.capture"), self.lock:
            t0 = time.perf_counter()
            side = self.stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            side.wait_event(self.done)
            with torch.cuda.stream(side):
                warm_up()  # every kernel loaded on this stream
                reserved = torch.cuda.memory_reserved(self.device)
                captured = profiling.captured(side)
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    outs = body()
                except Exception as e:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture was invalidated: the error above says why
                    raise RuntimeError(f"capturing {what} on {self.device} failed") from e
                graph.capture_end()
            self.done.record(side)
            torch.cuda.current_stream(self.device).wait_stream(side)
            return (graph, outs, profiling.captured(side) - captured,
                    torch.cuda.memory_reserved(self.device) - reserved, time.perf_counter() - t0)


_sites = {}
_sites_lock = threading.Lock()


def _timing_event(stream):
    event = torch.cuda.Event(enable_timing=True)
    event.record(stream)
    return event


def device_site(device):
    with _sites_lock:
        if device not in _sites:
            _sites[device] = DeviceSite(device)
        return _sites[device]


class RolloutProgram:
    """``steps`` decoder steps of B rows as one CUDA graph on a card (an
    eager loop on the CPU). ``step`` is `decoder.chunk_step`'s step,
    ``state`` the 10 state tensors it takes (h0, h1, root_pos, root_rot,
    root_vel, root_vrt, lpos, ltxy, lvel, lvrt; shapes and dtypes are
    copied, not the values) and ``widths`` the last dimensions of the
    step's per-frame inputs: the gaze, then each conditioning tensor."""

    def __init__(self, step, state, widths, steps):
        self.step, self.steps = step, int(steps)
        self.device = state[0].device
        self.rows = state[0].shape[0]
        self.capture_seconds = 0.0
        self.graph_bytes = 0  # static buffers and the graph's memory pool
        self.counts = {}  # what a replay counts (`utils.profiling.replayed`)
        if self.device.type != "cuda":
            return
        self._site = device_site(self.device)
        with torch.cuda.device(self.device):
            self._state = tuple(torch.zeros_like(s, memory_format=torch.contiguous_format)
                                for s in state)
            self._cond = tuple(torch.zeros((self.rows, self.steps, w), device=self.device)
                               for w in widths)
            self.graph_bytes = sum(t.numel() * t.element_size() for t in self._state + self._cond)
            self._capture()

    def _body(self, steps):
        """``steps`` steps from the static state over the static conditioning
        -> the stacked outputs (B, steps, ...); the new state is written back
        into the static state."""
        state = self._state
        emitted = [[] for _ in OUTPUTS]
        for t in range(steps):
            state = self.step(*(c[:, t] for c in self._cond), *state)
            for e, i in zip(emitted, OUTPUTS):
                e.append(state[2 + i])
        outs = tuple(torch.stack(e, dim=1) for e in emitted)
        for dst, src in zip(self._state, state):
            dst.copy_(src)
        return outs

    def _capture(self):
        self._graph, self._outs, self.counts, reserved, self.capture_seconds = \
            self._site.capture(lambda: self._body(1), lambda: self._body(self.steps),
                               f"the rollout program of {self.rows} rows and {self.steps} steps")
        self.graph_bytes += reserved

    def run(self, state, cond, outs, start, reps, events=None):
        """``reps`` x ``steps`` steps from ``state`` over the columns
        [start, start + reps * steps) of ``cond`` (the (B, n, ...) gaze and
        conditioning tensors, in the order of ``widths``); each step's
        outputs go to those columns of ``outs`` (root_pos, root_rot, lpos,
        ltxy, each (B, n, ...)). Returns the new state (tensors of the
        caller's). ``events`` (a card): a list that gets a timing event
        before the first replay if it is empty, and ends with one after the
        last."""
        with profiling.annotate("zeggs:program.rollout"):
            state = self._run(state, cond, outs, start, reps, events)
        profiling.count("programs.rollout_steps", reps * self.steps)
        return state

    def _run(self, state, cond, outs, start, reps, events):
        stop = start + reps * self.steps
        if self.device.type != "cuda":
            for t in range(start, stop):
                state = self.step(*(c[:, t] for c in cond), *state)
                for o, i in zip(outs, OUTPUTS):
                    o[:, t] = state[2 + i]
            return state
        with self._site.lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._site.done)  # the device's last graph work
            for dst, src in zip(self._state, state):
                dst.copy_(src)
            if events is not None and not events:
                events.append(_timing_event(stream))
            for t in range(start, stop, self.steps):
                for dst, src in zip(self._cond, cond):
                    dst.copy_(src[:, t : t + self.steps])
                self._graph.replay()
                for o, s in zip(outs, self._outs):
                    o[:, t : t + self.steps].copy_(s)
                profiling.replayed(self.counts)
            if events is not None:
                events[1:] = [_timing_event(stream)]
            state = tuple(s.clone() for s in self._state)
            self._site.done.record(stream)
        return state


class FinishProgram:
    """A stage that follows a chunk's rollout, over its B rows and T frames,
    as one CUDA graph on a card (the stage itself on the CPU), with static
    buffers for the stage's four inputs and for its outputs. ``like``: four
    (B, T, ...) tensors whose shapes and dtypes the inputs take; ``stage``:
    the function of the four that the graph runs (`output_stage` at a
    transfer dtype, or `bake`); ``pool``: the graph memory pool the capture
    allocates from (None: a pool of its own)."""

    def __init__(self, like, stage, pool=None):
        self.stage = stage
        self.device = like[0].device
        self.rows, self.frames = like[0].shape[:2]
        self.capture_seconds = 0.0
        self.graph_bytes = 0  # static inputs and what the capture reserved in its pool
        if self.device.type != "cuda":
            return
        self._site = device_site(self.device)
        with torch.cuda.device(self.device):
            self._inputs = tuple(torch.zeros_like(t, memory_format=torch.contiguous_format)
                                 for t in like)
            self._graph, self._outs, _, reserved, self.capture_seconds = self._site.capture(
                lambda: stage(self._inputs),
                lambda: stage(self._inputs),
                f"a finish stage of {self.rows} rows and {self.frames} frames",
                pool=pool)
        self.graph_bytes = sum(t.numel() * t.element_size() for t in self._inputs) + reserved

    def run(self, out):
        """The chunk's four tensors ``out`` through the stage -> its outputs,
        tensors of the caller's. On a card ``out`` is copied into the
        graph's inputs and the outputs out of its buffers, which the next
        replay overwrites while this chunk's copies to the host may still
        run; all under the device's lock and event, as a
        `RolloutProgram` run."""
        with profiling.annotate("zeggs:program.finish"):
            return self._run(out)

    def _run(self, out):
        if self.device.type != "cuda":
            return self.stage(out)
        with self._site.lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self._site.done)  # the device's last graph work
            for dst, src in zip(self._inputs, out):
                dst.copy_(src)
            self._graph.replay()
            outs = tuple(o.clone() for o in self._outs)
            self._site.done.record(stream)
        return outs


class ProgramCache:
    """The rollout programs of one decoder, of either cell, on its device
    (counterpart of `zeggs_tpu`'s ``_rollout_cache`` and
    ``pipe._stream_fn_cache``), keyed by (device, slot, B, steps, int8),
    its finish programs, keyed by (device, B, T, transfer dtype), and its
    bake programs, keyed by (device, B, T, the dtype they read), made at
    their first use or by `infer.batch.warmup`. ``stats``: the decoder's
    pose statistics on the same device; ``dt``: the frame time."""

    def __init__(self, dec, stats, dt):
        self.dec, self.dt = dec, dt
        self.stats = tuple(stats[k] for k in _STATS)
        self.device = dec.cell.out.weight.device
        self._programs = {}
        self._finishes = {}
        self._bakes = {}
        # the finish and bake programs' shared graph pool; a pool is given up
        # when the last graph captured into it is freed, so it lives with the
        # cache
        self._finish_pool = None
        self._steps = {}
        self._lock = threading.RLock()
        # (start, end) timing events of chunks whose device time is not yet
        # in ``programs.rollout_device_s``
        self._timed = []
        self._timed_lock = threading.Lock()

    def _chunk_step(self, njoints, quantize_int8):
        key = (njoints, bool(quantize_int8))
        with self._lock:
            if key not in self._steps:
                conditioning, step, plain = decoder.chunk_step(self.dec, *self.stats, self.dt,
                                                               njoints, quantize_int8)
                if plain:
                    raise RuntimeError("rollout programs are inference only: call under "
                                       "torch.inference_mode()")
                self._steps[key] = conditioning, step
            return self._steps[key]

    def program(self, state, cond, steps, quantize_int8=False, slot=0):
        """The program of ``steps`` steps for the shapes of ``state`` (the
        10 step-state tensors) and of ``cond`` (the gaze and conditioning
        tensors), made on first use."""
        key = (self.device, slot, state[0].shape[0], int(steps), bool(quantize_int8))
        with self._lock:
            if key not in self._programs:
                _, step = self._chunk_step(state[6].shape[1], quantize_int8)
                self._programs[key] = RolloutProgram(step, state,
                                                     tuple(c.shape[-1] for c in cond), steps)
            return self._programs[key]

    def programs(self):
        """(key, program) of every program made so far."""
        with self._lock:
            return list(self._programs.items())

    def finish(self, like, dtype):
        """The finish program for chunks shaped as ``like`` (root_pos,
        root_rot, lpos, ltxy (B, T, ...)) and the transfer ``dtype``, made on
        first use. Its runs are whole under the device's lock, so callers
        that run at once share it."""
        key = (self.device, like[0].shape[0], like[0].shape[1], dtype)
        return self._made(self._finishes, key, like, functools.partial(output_stage, dtype=dtype))

    def bake(self, out):
        """A chunk's rollout ``out`` (root_pos, root_rot, lpos, lrot (B, T,
        ...)) -> its BVH channels (`bake`), run by the bake program for its
        shapes and dtype, made on first use and shared as a finish program
        is."""
        key = (self.device, out[0].shape[0], out[0].shape[1], out[0].dtype)
        return self._made(self._bakes, key, out, bake).run(out)

    def _made(self, table, key, like, stage):
        with self._lock:
            if key not in table:
                if self._finish_pool is None and self.device.type == "cuda":
                    self._finish_pool = torch.cuda.graph_pool_handle()
                try:
                    table[key] = FinishProgram(like, stage, self._finish_pool)
                except Exception:
                    if not (self._finishes or self._bakes):  # no graph holds the pool
                        self._finish_pool = None
                    raise
            return table[key]

    def finishes(self):
        """(key, finish program) of every finish program made so far."""
        with self._lock:
            return list(self._finishes.items())

    def bakes(self):
        """(key, bake program) of every bake program made so far."""
        with self._lock:
            return list(self._bakes.items())

    def settle(self):
        """Add to the counter ``programs.rollout_device_s`` the device time
        of every timed chunk whose end event has passed; it waits for
        nothing. `infer.batch.generate_batch` calls it once a chunk's
        outputs are on the host, `rollout_chunk` before each chunk."""
        with self._timed_lock:
            passed = [end.query() for _, end in self._timed]
            done = [pair for pair, p in zip(self._timed, passed) if p]
            self._timed = [pair for pair, p in zip(self._timed, passed) if not p]
        for start, end in done:
            profiling.count("programs.rollout_device_s", start.elapsed_time(end) / 1e3)

    def rollout_chunk(self, carry, gaze_pos, speech_encoding, style_encoding, quantize_int8=False,
                      slot=0):
        """`decoder.rollout_chunk` with ``output_indices=(0, 1, 4, 5)``: n =
        ``speech_encoding.shape[1]`` steps from ``carry``, the cell's
        conditioning hoisted over all n, then the programs' grains. Returns
        (new_carry, (root_pos, root_rot, lpos, ltxy) (B, n, ...))."""
        B, n = speech_encoding.shape[:2]
        self.settle()
        conditioning, _ = self._chunk_step(carry[5].shape[1], quantize_int8)
        with profiling.annotate("zeggs:program.conditioning"):
            cond = (gaze_pos, *conditioning(speech_encoding, style_encoding))
        h, *pose_state = carry
        state = (h[0], h[1].contiguous(), *pose_state)
        outs = tuple(torch.empty((B, n) + tuple(state[2 + i].shape[1:]), dtype=state[2 + i].dtype,
                                 device=state[2 + i].device) for i in OUTPUTS)
        events = [] if self.device.type == "cuda" else None
        t = 0
        for steps, reps in ladder(n):
            program = self.program(state, cond, steps, quantize_int8, slot)
            state = program.run(state, cond, outs, t, reps, events)
            t += reps * steps
        if events:
            with self._timed_lock:
                self._timed.append(tuple(events))
        return (torch.stack(state[:2]),) + tuple(state[2:]), outs

    def rollout(self, state0, gaze_pos, speech_enc, style_enc, quantize_int8=False, slot=0,
                output_dtype=None):
        """`decoder.rollout` with ``output_indices=(0, 1, 4, 5)``: the
        cell-state encoder from frame 0, then `rollout_chunk` over frames
        1..T-1. Returns (root_pos, root_rot, lpos, ltxy) (B, T, ...), frame 0
        equal to the inputs; with an ``output_dtype``, (root_pos, root_rot,
        lpos, lrot) after `output_stage`, run by the chunk's finish
        program."""
        carry0 = decoder.init_carry(self.dec, *state0, gaze_pos[:, 0], style_enc[:, 0],
                                    *self.stats[:2])
        _, ys = self.rollout_chunk(carry0, gaze_pos[:, 1:], speech_enc[:, 1:], style_enc[:, 1:],
                                   quantize_int8, slot)
        out = tuple(torch.cat([state0[i][:, None], y], dim=1) for i, y in zip(OUTPUTS, ys))
        if output_dtype is None:
            return out
        return self.finish(out, output_dtype).run(out)
