"""Training step and the training loop, on one card or over several
processes (counterpart of `zeggs_tpu/train/loop.py`).

RAdam with lr = base * 0.995^floor(step / 1000), the 18-term loss,
checkpoints at ``generate_samples_step`` (the latest at the models
directory's root and one a checkpointed iteration) and ground/predict BVH
sample pairs. `make_train_step` is the plain eager step; `Trainer` runs the
same step as a `train.programs.TrainProgram`, replayed from CUDA graphs on
a card. Either way the decoder rollout runs under autograd
(`models.decoder.rollout_chunk`): at float32 without remat as one
autograd Function with the step kernels of `ops/kernels/decoder_train.py`
(their plain versions on the CPU), else as the differentiable plain step.
The GRU-cell kernel runs only in sample synthesis, which is inference:
its rollouts, of either decoder cell, replay the rollout programs of
`infer/programs.py` (a cache of them made for each synthesis, so that
none outlives a weight update).

Randomness: the batch order and example lengths come from a numpy
Generator seeded with ``train.seed`` (the JAX package's draws, in its
order); dropout masks and the VAE noise from a `torch.Generator` on the
training device. Both are saved in every checkpoint and restored on resume,
so a resumed run equals an uninterrupted one.

Several processes (`parallel.distributed.initialize` first) train as one:
see `Trainer`.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np
import torch

from ..config import Options
from ..data.dataset import WindowedDataset
from ..data.device_dataset import DeviceCorpus
from ..device import require_device
from ..infer.programs import ProgramCache
from ..io import checkpoint, weights
from ..models import decoder
from ..models.decoder import Decoder
from ..models.speech_encoder import SpeechEncoder
from ..models.layers import RowShard
from ..models.style_encoder import StyleEncoder
from ..ops import quat, xform
from ..parallel import distributed
from ..utils import write_bvh
from .loss import compute_loss
from .programs import TrainProgram
from .radam import RAdam, exponential_step_schedule

POSE_KEYS = ("root_pos", "root_rot", "root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt")


def init_networks(opts: Options, dims, nlabels, seed, device="cuda"):
    """The three networks ({name: module}, on ``device``: the card unless
    the caller asks for the CPU) at the JAX package's initial
    distributions: PyTorch's defaults, Xavier-uniform for the style
    encoder's ConvNorm/LinearNorm layers and the FiLM heads. The values come
    from the CPU generator seeded with ``seed``, whatever the device, and
    leave the global generator as it was."""
    device = require_device(device)
    net = opts.net
    label = opts.train.style_encoding_type == "label"
    style_size = nlabels if label else net.style_encoder.style_encoding_size
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        nets = {
            "speech_encoder": SpeechEncoder(
                dims["num_audio_features"], net.speech_encoder.nhidden,
                net.speech_encoder.speech_encoding_size,
            ),
            "decoder": Decoder(
                dims["pose_input_size"], dims["pose_output_size"],
                net.speech_encoder.speech_encoding_size, style_size, net.decoder.nhidden,
                net.decoder.num_rnn_layers, net.decoder.rnn_cond,
            ),
        }
        if not label:
            nets["style_encoder"] = StyleEncoder(
                dims["pose_input_size"], net.style_encoder.nhidden,
                net.style_encoder.style_encoding_size, net.style_encoder.use_vae,
                encoder_type=net.style_encoder.type,
            )
    return {k: m.to(device) for k, m in nets.items()}


def named_parameters(nets):
    """{"<network>.<parameter>": tensor} over every network."""
    return {f"{n}.{k}": p for n, m in nets.items() for k, p in m.named_parameters()}


def make_optimizer(opts: Options, nets):
    schedule = exponential_step_schedule(opts.train.learning_rate, opts.train.learning_rate_decay,
                                         every=1000)
    return RAdam(named_parameters(nets), schedule, eps=opts.train.eps)


def _stats_tensors(stats):
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in stats.items()}


def make_loss_fn(opts: Options, stats, parents, dt, deterministic=False):
    """``loss_fn(nets, batch, iteration, generator)`` -> (loss, metrics) on
    the batch's device. ``deterministic=True`` draws nothing: no dropout,
    style = mu (the parity tests' mode); otherwise dropout masks and the VAE
    noise come from ``generator``. ``iteration``: a number, or a float32
    tensor on the batch's device (`loss.kl_divergence`)."""
    net = opts.net
    label = opts.train.style_encoding_type == "label"
    compute_dtype = getattr(torch, opts.train.compute_dtype)
    parents = [int(p) for p in parents]
    host_stats = _stats_tensors(stats)
    on_device = {}

    def loss_fn(nets, batch, iteration, generator=None):
        dev = batch["audio_features"].device
        if dev not in on_device:
            on_device[dev] = {k: v.to(dev) for k, v in host_stats.items()}
        s = on_device[dev]
        gen = None if deterministic else generator
        audio = (batch["audio_features"] - s["audio_input_mean"]) / s["audio_input_std"]
        speech = nets["speech_encoder"](audio, generator=gen)
        mu = logvar = None
        if label:
            style = batch["style"]
        else:
            ex = (batch["example"] - s["anim_input_mean"]) / s["anim_input_std"]
            style, mu, logvar = nets["style_encoder"](
                ex, lengths=batch["example_lengths"], generator=gen, train=gen is not None)
        T = speech.shape[1]
        outputs = decoder.rollout(
            nets["decoder"], *(batch[k][:, 0] for k in POSE_KEYS), batch["gaze_pos"], speech,
            style[:, None].expand(-1, T, -1), s["anim_input_mean"], s["anim_input_std"],
            s["anim_output_mean"], s["anim_output_std"], dt, compute_dtype=compute_dtype,
            remat=opts.train.remat,
        )
        O = dict(zip(POSE_KEYS, outputs))
        W = {k: batch[k] for k in POSE_KEYS}
        return compute_loss(O, W, batch["gaze_pos"], parents, dt, mu, logvar, iteration)

    return loss_fn


def make_train_step(opts: Options, stats, parents, dt, nets, deterministic=False):
    """(optimizer, step), the plain eager train step: ``step(batch,
    iteration, generator)`` computes the loss, its gradients (left in the
    parameters' .grad) and one RAdam update in place, and returns the
    metrics as 0-d tensors. Over several processes each holds its rows of
    the batch; the gradients and the metrics are averaged over the
    processes before the update, which makes them the single process's over
    the whole batch (every loss term is a mean over rows). `TrainProgram`
    runs the same step from CUDA graphs; the tests hold it to this one."""
    optimizer = make_optimizer(opts, nets)
    loss_fn = make_loss_fn(opts, stats, parents, dt, deterministic)

    def step(batch, iteration, generator=None):
        params = list(optimizer.params.values())
        for p in params:
            p.grad = None
        loss, metrics = loss_fn(nets, batch, iteration, generator)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        distributed.average_([p.grad for p in params] + list(metrics.values()))
        optimizer.step()
        return metrics

    return optimizer, step


def _seed_of(*words):
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(1)[0])


class Trainer:
    """Host loop: epochs, logging, checkpoints, sample synthesis. Each
    step is one run of the trainer's `TrainProgram` (CUDA graphs on a card,
    after one eager warm-up step a run). ``device_corpus`` (the default)
    uploads the corpus once, and each step copies in only the window
    starts and example rows (or labels) and gathers the batch inside the
    program; otherwise batches are assembled on the host and copied into
    the program's batch buffers (for corpora larger than the card). Every
    example is ``ds.max_example_length`` frames wide, masked past its
    drawn length, so the dropout and VAE noise of the style encoder is
    drawn at that width.

    Several processes (`parallel.distributed.initialize` first): every
    process builds the same Trainer from the same options and seed over a
    shared filesystem, on its own card (``cuda:(local_rank %
    device_count)``; the CPU with ``device="cpu"``), and checks that every
    process holds rank 0's parameters and optimizer state. The batch indices
    and example lengths come from the shared host generator, so they agree
    on every process, and each process takes its `local_batch_slice` of the
    batch, on either data path (each uploads the device corpus to its own
    card). Each process draws the dropout and VAE noise of the whole batch
    from the same generator and keeps its own rows (`RowShard`); the
    gradients are averaged before RAdam. So N processes equal one process
    at the same seed, and one generator state in the checkpoint resumes
    every process. The batch size must divide by the number of processes.
    Only rank 0 writes checkpoints, samples and metrics; the others wait at
    a barrier before and after its section."""

    def __init__(self, opts: Options, models_dir, logs_dir, path_processed_data,
                 path_data_definition, writer=None, device_corpus=True, device="cuda"):
        self.opts = opts
        self.device = require_device(distributed.process_device(device))
        self.rank, self.world = distributed.process_index(), distributed.process_count()
        t = opts.train
        if t.batchsize % self.world:
            raise ValueError(f"batchsize {t.batchsize} must divide evenly across {self.world} "
                             "processes")
        self.models_dir = Path(models_dir)
        self.logs_dir = Path(logs_dir)
        self.samples_dir = self.logs_dir / "samples"
        if self.rank == 0:
            self.samples_dir.mkdir(parents=True, exist_ok=True)
        self.ds = WindowedDataset(
            path_data_definition, path_processed_data, t.window,
            style_encoding_type=t.style_encoding_type,
            example_length=opts.net.style_encoder.example_length,
        )
        self.rng = np.random.default_rng(t.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(_seed_of(t.seed, 1))
        self.nets = init_networks(opts, self.ds.get_shapes(), self.ds.nlabels, t.seed,
                                  self.device)
        self.stats = {k: v.to(self.device) for k, v in _stats_tensors(self.ds.stats).items()}
        self.optimizer = make_optimizer(opts, self.nets)
        self.device_corpus = DeviceCorpus(self.ds, self.device) if device_corpus else None
        generator = self.generator
        if self.world > 1:
            generator = RowShard(generator, t.batchsize, distributed.local_batch_slice(
                t.batchsize)[0])
        self.program = TrainProgram(
            make_loss_fn(opts, self.ds.stats, self.ds.parents, self.ds.dt), self.nets,
            self.optimizer, generator, self.device_corpus, self.ds.nlabels)
        self.iteration = 0
        self.epoch = 0
        self.writer = writer
        if t.resume and (self.models_dir / "checkpoint.json").exists():
            self._resume()
        _, exp_avg, exp_avg_sq = self.optimizer.state()
        distributed.make_replicated([*self.optimizer.params.values(), *exp_avg.values(),
                                     *exp_avg_sq.values()])

    def _resume(self):
        nets, opt_state, meta = checkpoint.load_train_state(self.models_dir)
        for name, module in self.nets.items():
            module.load_state_dict(weights.from_jax(nets[name]), strict=True)
        if opt_state is not None:
            step, exp_avg, exp_avg_sq = weights.opt_state_from_jax(opt_state)
            self.optimizer.load_state(step, *(
                {f"{n}.{k}": v for n, sd in moment.items() for k, v in sd.items()}
                for moment in (exp_avg, exp_avg_sq)))
        self.iteration = int(meta["step"])
        # lossless: epoch, data order and the dropout/VAE generator continue
        self.epoch = int(meta.get("epoch", 0))
        if "np_rng_state" in meta:
            self.rng.bit_generator.state = meta["np_rng_state"]
        if "torch_generator_state" in meta:
            self.generator.set_state(torch.tensor(meta["torch_generator_state"], dtype=torch.uint8))
        elif "prng_key" in meta:  # a checkpoint of the JAX package: a key, not a state
            self.generator.manual_seed(_seed_of(*meta["prng_key"]))

    # ------------------------------------------------------------------

    def run(self, max_iterations=None, log_every=10, on_step=None):
        """Train to ``max_iterations`` (default 1000 * niterations); on any
        failure the latest state is checkpointed before the error goes on."""
        total = max_iterations if max_iterations is not None else 1000 * self.opts.train.niterations
        start_time = datetime.datetime.now()
        try:
            self._run_epochs(total, log_every, on_step)
        except BaseException:
            self.save_checkpoint()
            raise
        print(f"trained to iteration {self.iteration} in {datetime.datetime.now() - start_time}")
        return self.nets

    def train_step(self, inputs):
        """One step on this process's inputs (`_batch`) -> metrics (0-d
        tensors, over the whole batch)."""
        return self.program.run(inputs, self.iteration)

    def _post_step(self, metrics, log_every, on_step):
        if self.writer is not None and self.rank == 0 and self.iteration % log_every == 0:
            self.writer.write(self.iteration, {k: float(v) for k, v in metrics.items()})
        if on_step is not None:
            on_step(self.iteration, metrics)
        if self.iteration % self.opts.train.generate_samples_step == 0:
            # the other processes wait while rank 0 writes
            distributed.barrier()
            self.save_checkpoint()
            self.generate_samples(3)
            distributed.barrier()
        self.iteration += 1

    def _run_epochs(self, total, log_every, on_step):
        t = self.opts.train
        ds = self.ds
        label = t.style_encoding_type == "label"
        while self.iteration < total:
            order = self.rng.permutation(len(ds))
            for b in range(len(order) // t.batchsize):
                if self.iteration >= total:
                    break
                idx = order[b * t.batchsize : (b + 1) * t.batchsize]
                ewl = None if label else ds.sample_example_length(self.rng)
                metrics = self.train_step(self._batch(distributed.host_shard(idx), ewl))
                self._post_step(metrics, log_every, on_step)
            self.epoch += 1

    def _batch(self, idx, ewl):
        """The program's inputs for window indices ``idx`` with examples of
        ``ewl`` frames (None: label styles), host arrays: the batch itself
        without a device corpus (examples ``ds.max_example_length`` wide,
        with their lengths); else the window starts and the example rows
        and lengths (`DeviceCorpus.sample_indices`), or the labels."""
        ds, corpus = self.ds, self.device_corpus
        if corpus is None:
            return ds.make_batch(idx, example_window_length=ewl)
        if ewl is None:
            return {"window_starts": ds.window_starts[idx], "labels": ds.window_labels[idx]}
        starts, ex_idx, ex_len = corpus.sample_indices(idx, ewl)
        return {"window_starts": starts, "ex_idx": ex_idx, "ex_lengths": ex_len}

    # ------------------------------------------------------------------

    def save_checkpoint(self):
        """The networks and RAdam state in the JAX package's layout, with
        the loop state, at the models directory and under <iteration>/;
        rank 0 only."""
        if self.rank != 0:
            return
        nets = {k: weights.to_jax(m) for k, m in self.nets.items()}
        step, exp_avg, exp_avg_sq = self.optimizer.state()

        def by_network(moment):
            return {n: {k: moment[f"{n}.{k}"] for k, _ in m.named_parameters()}
                    for n, m in self.nets.items()}

        opt = weights.opt_state_to_jax(self.nets, step, by_network(exp_avg),
                                       by_network(exp_avg_sq))
        extra = {
            "epoch": self.epoch,
            "np_rng_state": self.rng.bit_generator.state,
            "torch_generator_state": self.generator.get_state().tolist(),
        }
        checkpoint.save_train_state(self.models_dir, self.iteration, nets, opt, extra)
        checkpoint.save_train_state(self.models_dir / str(self.iteration), self.iteration, nets,
                                    opt, extra)

    @torch.inference_mode()
    def generate_samples(self, n=3, length_s=30):
        """Ground/predict BVH pairs of ``n`` train and ``n`` validation clips
        (at most ``length_s`` seconds each), the style from an example of the
        clip (mu) or its label. Draws come from a generator of their own,
        never the data order's. The rollouts replay rollout programs from a
        cache made here and dropped on return (its graphs hold the weights'
        derived tensors). Returns (decoder steps run, programs captured);
        rank 0 only (other processes run none)."""
        if self.rank != 0:
            return 0, 0
        rng = np.random.default_rng([self.opts.train.seed, 0x5A11, self.iteration])
        ds, s, dev = self.ds, self.stats, self.device
        nets = self.nets
        programs = ProgramCache(nets["decoder"], s, ds.dt)
        steps = 0
        for which in ("train", "valid"):
            if not len(ds.ranges_train if which == "train" else ds.ranges_valid):
                continue
            for i in range(n):
                sample, label, (a, e), _ = ds.get_sample(which, length_s, rng=rng)
                audio = (torch.as_tensor(sample["audio_features"], device=dev)
                         - s["audio_input_mean"]) / s["audio_input_std"]
                speech = nets["speech_encoder"](audio)
                if self.opts.train.style_encoding_type == "example":
                    vec = ds.get_example(a, a + ds.window, (a, e), ds.sample_example_length(rng))
                    ex = (torch.as_tensor(vec[None], device=dev) - s["anim_input_mean"]) / s[
                        "anim_input_std"]
                    style = nets["style_encoder"](ex)[0]
                else:
                    style = torch.zeros((1, ds.nlabels), device=dev)
                    style[0, label] = 1.0
                T = speech.shape[1]
                state0 = tuple(torch.as_tensor(sample[k][:, 0], device=dev) for k in POSE_KEYS)
                gaze = torch.as_tensor(sample["gaze_pos"], device=dev)
                style_t = style[:, None].expand(-1, T, -1)
                out = programs.rollout(state0, gaze, speech, style_t)
                steps += T - 1
                pairs = {
                    "ground": (sample["root_pos"][0], sample["root_rot"][0], sample["lpos"][0],
                               torch.as_tensor(sample["ltxy"][0])),
                    "predict": tuple(o[0].float().cpu() for o in out),
                }
                for tag, (rp, rr, lp, lt) in pairs.items():
                    lrot = quat.from_xform(xform.orthogonalize_from_xy(lt))
                    write_bvh(
                        str(self.samples_dir / f"iteration_{self.iteration}_{which}_{tag}_{i}_"
                                               f"{ds.label_names[label]}.bvh"),
                        rp, rr, lp, lrot, parents=ds.parents, names=ds.bone_names, order="zyx",
                        dt=ds.dt,
                    )
        return steps, len(programs.programs())
