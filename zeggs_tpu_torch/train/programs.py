"""The train step as a captured program (counterpart of `zeggs_tpu`'s
`train/loop.py::make_train_step` and `data/device_dataset.py::
make_device_train_step`: one jitted program with donated state, the batch
gathered on the device inside it, so that only index vectors cross to the
device).

A `TrainProgram` is the PyTorch counterpart on a card: CUDA graphs with
static buffers. Each step the host writes the step's inputs into one pinned
staging buffer and copies it to the device in one copy; the graph then
runs from those addresses:

  * the inputs: with a `DeviceCorpus`, (B,) window starts and (B, Lmax)
    example rows with their (B,) lengths, or (B,) labels; without one (the
    CLI's ``--host-batches``), the host-assembled batch itself. The example
    width is static at the dataset's longest example (Lmax), masked past
    each row's length, as JAX's gather does; so one graph serves every
    batch;
  * the step's scalars: the iteration (float32, the KL anneal's input) and
    RAdam's three scalars (`RAdam.scalars`, computed on the host).

What a graph holds. One process: the gather, the loss forward
(`train/loop.py::make_loss_fn`), ``backward()``, the metrics stacked into
one static vector, and the RAdam update (`RAdam.apply`). Several processes:
graph A holds the gather, forward, backward and metrics; then
`parallel.distributed.average_` runs eagerly on A's static gradients and
metric vector (a collective of gloo cannot be captured, and the port lets
several processes share one card over gloo); then graph B holds the RAdam
update. Two processes equal one as they do eagerly.

Warm-up and capture. The program's first step runs eagerly on the device's
capture stream: a real training step, which also fills every cache the
step reads (the loss's statistics on the device, the style encoder's
positional table, cuBLAS's workspace on that stream). The gradients are
then set to None and the second step is captured and replayed; every later
step is a replay. A capture records work and runs none, so N steps of a
program equal N eager steps: the dropout and VAE noise come from the
trainer's generator, registered with the graph that draws it, which hands
each replay the generator's offset and advances it by what the graph
draws, as the eager step would (its state after replays resumes exactly).
The gradients are the graph's static tensors from the capture on, and
nothing rebinds them. A capture that fails raises: a card has no eager
fall-back. Captures and replays follow the device's order for graph work
(`infer/programs.py::device_site`): one lock and one event a device, shared
with the rollout programs of sample synthesis.

Every training option is captured: float32 and bfloat16 compute, remat
(`torch.utils.checkpoint` recomputes inside the captured backward), both
style bodies, the FiLM cell, label styles and host batches.

On the CPU every step runs the same body eagerly (the path the tests hold
to `zeggs_tpu` and to `train/loop.py::make_train_step`, the plain step).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..infer.programs import device_site
from ..models.layers import RowShard
from ..parallel import distributed
from ..utils import profiling

#: the step's scalars at the head of the staging buffer: the iteration and
#: RAdam's (a, c, d)
_SCALARS = 4
_ALIGN = 64  # bytes: each input starts on a 64-byte boundary


def _torch_dtype(dtype):
    return torch.from_numpy(np.empty(0, dtype)).dtype


class TrainProgram:
    """One training step of ``nets`` as CUDA graphs on a card (an eager step
    on the CPU).

    ``loss_fn(nets, batch, iteration, generator)`` is `make_loss_fn`'s;
    ``optimizer`` the `RAdam` over the networks' parameters; ``generator``
    the dropout and VAE noise's `torch.Generator` or its `RowShard` (None:
    the loss draws nothing). ``corpus``: a `DeviceCorpus` to gather from,
    with ``nlabels`` for label styles; None: each step's inputs are the
    batch itself."""

    def __init__(self, loss_fn, nets, optimizer, generator=None, corpus=None, nlabels=None):
        self.loss_fn, self.nets, self.optimizer = loss_fn, nets, optimizer
        self.generator, self.corpus, self.nlabels = generator, corpus, nlabels
        self.device = next(iter(optimizer.params.values())).device
        self.several = distributed.process_count() > 1
        self.steps = 0
        self.capture_seconds = 0.0
        self.graph_bytes = 0  # the graphs' memory pools
        # what a replay counts (`utils.profiling.replayed`): the training
        # rollout's kernel launches and passes
        self.counts = {}
        # one graph (one process) or two (A, B); each keeps its captured
        # cudaGraph_t beside the executable (``keep_graph``), so that a
        # caller can count its nodes (`CUDAGraph.raw_cuda_graph`)
        self.graphs = []
        self._layout = None  # name -> (offset, dtype, shape) in the staging buffers
        self._copied = None  # the event after the last staging copy
        self._names = None  # the metrics' names, in the static vector's order

    # -- inputs ------------------------------------------------------------

    def _make_layout(self, inputs):
        layout, offset = {}, _SCALARS * 4
        for name, a in inputs.items():
            a = np.asarray(a)
            offset = -(-offset // _ALIGN) * _ALIGN
            layout[name] = (offset, a.dtype, a.shape)
            offset += a.nbytes
        cuda = self.device.type == "cuda"
        self._host = torch.empty(offset, dtype=torch.uint8, pin_memory=cuda)
        self._dev = torch.empty(offset, dtype=torch.uint8, device=self.device)
        self._layout = layout

        def views(buf):
            out = {"scalars": buf[: _SCALARS * 4].view(torch.float32)}
            for name, (o, dtype, shape) in layout.items():
                n = int(np.prod(shape)) * dtype.itemsize
                out[name] = buf[o : o + n].view(_torch_dtype(dtype)).view(shape)
            return out

        self._host_np = {k: v.numpy() for k, v in views(self._host).items()}
        self._in = views(self._dev)

    def _stage(self, inputs, iteration):
        """Write this step's inputs and scalars into the pinned staging
        buffer, once the last copy out of it has run."""
        if self._layout is None:
            self._make_layout(inputs)
        if set(inputs) != set(self._layout):
            raise ValueError(f"the program's inputs are {sorted(self._layout)}, not "
                             f"{sorted(inputs)}")
        if self._copied is not None:
            self._copied.synchronize()
        for name, a in inputs.items():
            a = np.asarray(a)
            shape = self._layout[name][2]
            if a.shape != shape:
                raise ValueError(f"the program's input {name!r} is static at {shape}, not "
                                 f"{a.shape}")
            self._host_np[name][...] = a
        scalars = self._host_np["scalars"]
        scalars[0] = np.float32(iteration)
        scalars[1:] = self.optimizer.scalars()

    def _copy_in(self, stream=None):
        self._dev.copy_(self._host, non_blocking=True)
        if self.device.type == "cuda":
            self._copied = torch.cuda.Event()
            self._copied.record(stream)

    # -- the body ----------------------------------------------------------

    def _batch(self):
        x, corpus = self._in, self.corpus
        if corpus is None:
            return {k: x[k] for k in self._layout}
        if "labels" in x:
            return corpus.gather_batch(x["window_starts"], labels=x["labels"],
                                       nlabels=self.nlabels)
        return corpus.gather_batch(x["window_starts"], x["ex_idx"], x["ex_lengths"])

    def _forward_backward(self):
        """Gather, loss, backward -> the metrics as one (n,) vector."""
        loss, metrics = self.loss_fn(self.nets, self._batch(), self._in["scalars"][0],
                                     self.generator)
        loss.backward()
        if self._names is None:
            self._names = list(metrics)
        return torch.stack([metrics[k].detach() for k in self._names])

    def _update(self):
        self.optimizer.apply(self._in["scalars"][1:])

    def _average(self, metrics):
        distributed.average_([p.grad for p in self.optimizer.params.values()] + [metrics])

    def _eager_step(self):
        for p in self.optimizer.params.values():
            p.grad = None
        metrics = self._forward_backward()
        self._average(metrics)
        self._update()
        return metrics

    # -- running -----------------------------------------------------------

    def run(self, inputs, iteration):
        """One training step: ``inputs`` ({name: host array}, the same names
        and shapes every step; see `Trainer._batch`) at ``iteration`` ->
        the metrics ({name: 0-d tensor}, copies that later steps leave
        alone). Advances the optimizer's step count.

        Spans (`utils/profiling.py`): ``zeggs:train.stage``, then
        ``zeggs:train.eager`` or ``zeggs:train.replay``."""
        with profiling.annotate("zeggs:train.stage"):
            self._stage(inputs, iteration)
        if self.device.type != "cuda":
            with profiling.annotate("zeggs:train.eager"):
                self._copy_in()
                metrics = self._eager_step()
        elif self.steps == 0:
            with profiling.annotate("zeggs:train.eager"):
                metrics = self._on_capture_stream(self._eager_step)
        else:
            if not self.graphs:
                with profiling.annotate("zeggs:program.capture"):
                    self._on_capture_stream(self._capture)
            with profiling.annotate("zeggs:train.replay"):
                metrics = self._replay()
        self.optimizer.step_count += 1
        self.steps += 1
        return dict(zip(self._names, metrics.unbind()))

    def _on_capture_stream(self, fn):
        """``fn()`` on the device's capture stream, after the device's last
        graph work and this stream's work, with the staging copy first."""
        site = device_site(self.device)
        with site.lock, torch.cuda.device(self.device):
            current = torch.cuda.current_stream(self.device)
            side = site.stream
            side.wait_stream(current)
            side.wait_event(site.done)
            with torch.cuda.stream(side):
                self._copy_in(side)
                out = fn()
                out = out.clone() if out is not None else None
            site.done.record(side)
            current.wait_stream(side)
        return out

    def _capture(self):
        """Capture the step (graphs A and B over several processes) on the
        capture stream; nothing runs."""
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(self.device)
        for p in self.optimizer.params.values():
            p.grad = None
        generator = self.generator
        if isinstance(generator, RowShard):
            generator = generator.generator
        bodies = ([self._forward_backward, self._update] if self.several
                  else [lambda: (self._forward_backward(), self._update())[0]])
        graphs, outs = [], []
        captured = profiling.captured(torch.cuda.current_stream(self.device))
        for i, body in enumerate(bodies):
            profiling.count("programs.captures")
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            if generator is not None and i == 0:
                graph.register_generator_state(generator)
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs.append(body())
            except Exception as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated: the error above says why
                raise RuntimeError(f"capturing the train step on {self.device} failed") from e
            graph.capture_end()
            graph.instantiate()
            graphs.append(graph)
        self.graphs, self._metrics = graphs, outs[0]
        self.counts = profiling.captured(torch.cuda.current_stream(self.device)) - captured
        self.graph_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.capture_seconds = time.perf_counter() - t0

    def _replay(self):
        """One replay of the step. Counts ``train.replays`` and adds to
        ``train.replay_s`` the host's seconds from just before the first
        graph's ``replay()`` to the return of the last one's: the launch of
        the graphs' work, which the card runs meanwhile."""
        site = device_site(self.device)
        with site.lock, torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(site.done)  # the device's last graph work
            self._copy_in(stream)
            t0 = time.perf_counter()
            self.graphs[0].replay()
            if self.several:
                self._average(self._metrics)
                self.graphs[1].replay()
            launched = time.perf_counter() - t0
            profiling.replayed(self.counts)
            profiling.count("train.replays")
            profiling.count("train.replay_s", launched)
            metrics = self._metrics.clone()
            site.done.record(stream)
        return metrics
