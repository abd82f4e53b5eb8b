"""Training traffic: the recipe's train step, run as a training run issues
it (`zeggs_tpu_torch/train/programs.py::TrainProgram.run`) on windows drawn
from a corpus on the device.

The mix names the corpus size (frames), its takes, and how many replays
the traced stretch holds. Set-up makes the weights and the corpus from the
seed, uploads the corpus through the program's `DeviceCorpus`, and runs the
program's first three steps (eager, capture and replay, replay) on rows
that all differ: those are the steps the reference follows. The window
replays the step on fresh draws until ``--seconds`` have passed;
``train_step_ms`` is its wall time over the steps completed.

The check: the plain reference (`benchmark/reference`) runs the same three
steps from the same weights, batches and generator seed. Compared, each
relative to the reference: the worst step's loss; the worst leaf's norm of
the first gradient, which the program's RAdam state gives after one step
(m = (1 - b1) g); the worst leaf's norm of the parameters' change over the
three steps, which RAdam's first steps make from the three gradients, the
two replayed ones among them. A leaf's gap is taken
against the larger of its own reference norm and the median leaf's. Leaves
whose reference gradient is under a thousandth of the median leaf's are
left out of the change.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.common import log, seed_of
from benchmark.reference import model as ref
from benchmark.reference.precision import precision
from benchmark.trace import span

#: the steps set-up runs and the reference follows
CHECKED_STEPS = 3


def leaf_gaps(prog, refr, keep=None):
    """{leaf: |prog - ref| / max(ref, median ref)} (norms a leaf) over the
    leaves in ``keep`` (all by default)."""
    med = float(np.median([refr[k] for k in refr]))
    return {k: abs(prog[k] - refr[k]) / max(refr[k], med)
            for k in refr if keep is None or k in keep}


class Run:
    def __init__(self, cell, cfg, seed, device):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.device = torch.device(device)
        self.mix = cell.mix
        self.parts = {}
        self._refs = {}

    # -- set-up --------------------------------------------------------------

    def setup(self):
        from zeggs_tpu_torch.config import Options
        from zeggs_tpu_torch.data.device_dataset import DeviceCorpus
        from zeggs_tpu_torch.train import loop
        from zeggs_tpu_torch.train.programs import TrainProgram

        cfg, ds, dev = self.cfg, self.cfg["dataset"], self.device
        opts = Options.from_options_dict(cfg)
        train = cfg["train_opt"]
        self.B, self.window_len = train["batchsize"], train["window"]
        dims = dict(num_audio_features=ds["audio_features"],
                    pose_input_size=ds["pose_input_size"],
                    pose_output_size=ds["pose_output_size"])
        self.parents = inputs.skeleton(ds["njoints"])[1]
        self.dt = 1.0 / ds["fps"]
        self.stats = inputs.make_stats(cfg, self.seed)

        t = time.perf_counter()
        self.nets = loop.init_networks(opts, dims, nlabels=len(ds["styles"]), seed=0, device=dev)
        params = inputs.make_params(cfg, self.seed, dev)
        ref.load(self.nets, params)
        del params
        self.optimizer = loop.make_optimizer(opts, self.nets)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed_of(self.seed, 4))
        self.parts["weights_s"] = time.perf_counter() - t

        t = time.perf_counter()
        n_frames = int(self.mix["corpus_frames"])
        arrays = inputs.make_corpus(n_frames, ds["njoints"], self.seed, dev, ds["audio_features"])
        host = {k: v.cpu() for k, v in arrays.items()}
        del arrays
        index = inputs.CorpusIndex(host, int(self.mix["takes"]), self.window_len,
                                   cfg["net_opt"]["style_encoder"]["example_length"])
        self.corpus = DeviceCorpus(index, dev)
        # the host copy goes; the example indexing reads only the corpus length
        index.arrays = {"root_vel": np.broadcast_to(np.zeros(1, np.float32), (n_frames, 3))}
        del host
        self.corpus_bytes = sum(a.numel() * a.element_size() for a in self.corpus.arrays.values())
        self.parts["inputs_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.program = TrainProgram(loop.make_loss_fn(opts, self.stats, self.parents, self.dt),
                                    self.nets, self.optimizer, self.generator, self.corpus)
        self.rng = np.random.default_rng(seed_of(self.seed, 5))
        n_windows = len(self.corpus.ds.window_starts)
        rows = self.rng.choice(n_windows, CHECKED_STEPS * self.B, replace=False)
        self.checked_inputs, self.losses = [], []
        for i in range(CHECKED_STEPS):
            inp = self._inputs(rows[i * self.B : (i + 1) * self.B])
            self.checked_inputs.append(inp)
            with span("train_step"):
                metrics = self.program.run(inp, i)
            self.losses.append(float(metrics["total_loss"]))
            if i == 0:
                b1 = self.optimizer.b1
                self.grad_norms = {k: float(torch.linalg.norm(m)) / (1.0 - b1)
                                   for k, m in self.optimizer.exp_avg.items()}
        params0 = inputs.make_params(cfg, self.seed, dev)
        self.change_norms = {k: float(torch.linalg.norm(p.detach() - params0[k]))
                             for k, p in self.optimizer.params.items()}
        del params0
        self.iteration = CHECKED_STEPS
        self._sync()
        self.parts["steps_s"] = time.perf_counter() - t
        self.parts["capture_s"] = self.program.capture_seconds
        log(f"checked steps: losses {self.losses}")

    def setup_parts(self):
        return {k: round(v, 3) for k, v in self.parts.items()}

    def _inputs(self, rows):
        ewl = int(2 * self.rng.integers(self.window_len // 2, self.window_len + 1))
        starts, ex_idx, ex_len = self.corpus.sample_indices(rows, ewl)
        return {"window_starts": starts, "ex_idx": ex_idx, "ex_lengths": ex_len}

    def _draw(self):
        return self._inputs(self.rng.integers(0, len(self.corpus.ds.window_starts), self.B))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self):
        with span("train_step"):
            metrics = self.program.run(self._draw(), self.iteration)
        self.iteration += 1
        return metrics

    # -- the window ------------------------------------------------------------

    def window(self, seconds):
        self._sync()
        t0 = time.perf_counter()
        n, metrics, marks = 0, None, [t0]
        while marks[-1] - t0 < seconds:
            metrics = self._step()
            n += 1
            marks.append(time.perf_counter())
        self._sync()
        wall = time.perf_counter() - t0
        q = np.percentile(np.diff(marks) * 1e3, [0, 25, 50, 75, 100])
        log(f"host time between steps, ms (min, quartiles, max): {q.round(2).tolist()}")
        self.step_s = wall / n
        self.window_steps = n
        last = float(metrics["total_loss"])
        failed = 0 if np.isfinite(last) else 1
        return {"metrics": {"train_step_ms": self.step_s * 1e3}, "attempted": n,
                "failed": failed}

    def traced_stretch(self):
        for _ in range(int(self.mix["trace_replays"])):
            self._step()

    def flops_per_step(self):
        from benchmark import flops

        return flops.train_step_flops(self.cfg)

    def release(self):
        for name in ("program", "optimizer", "nets", "corpus", "generator"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check ---------------------------------------------------------

    def reference(self, tf32=False, half=False):
        """The reference's (losses, first gradients' norms, change norms)
        over the checked steps, products in TF32 with ``tf32``; with
        ``half``, the loss of each step over the first half of its rows (a
        fault: half of the batch left out)."""
        key = (tf32, half)
        if key not in self._refs:
            self._refs[key] = self._reference(tf32, half)
        return self._refs[key]

    def _reference(self, tf32, half):
        cfg, dev = self.cfg, self.device
        ds = cfg["dataset"]
        with precision(tf32):
            arrays = inputs.make_corpus(int(self.mix["corpus_frames"]), ds["njoints"], self.seed,
                                        dev, ds["audio_features"])
            params = inputs.make_params(cfg, self.seed, dev)
            nets = inputs.reference_networks(cfg, {k: v.clone() for k, v in params.items()}, dev)
            stats = inputs.stats_on(self.stats, dev)
            batches = [ref.gather_batch(arrays, self.window_len, **inp)
                       for inp in self.checked_inputs]
            if half:
                batches = [{k: v[: self.B // 2] for k, v in b.items()} for b in batches]
            del arrays
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed_of(self.seed, 4))
            losses, grads = ref.train_steps(cfg, nets, stats, self.parents, self.dt, batches,
                                            generator)
            grad_norms = {k: float(torch.linalg.norm(g)) for k, g in grads.items()}
            after = ref.named_parameters(nets)
            change = {k: float(torch.linalg.norm(after[k].detach() - params[k]))
                      for k in params}
            return losses, grad_norms, change

    def compare(self, prog, refr):
        """The numbers compared: (losses, gradient norms, change norms) of
        the side under test against the reference's, each by its worst
        leaf (the median leaf is logged beside it)."""
        (lp, gp, cp), (lr, gr, cr) = prog, refr
        med = float(np.median(list(gr.values())))
        moved = {k for k, v in gr.items() if v >= 1e-3 * med}
        grads, changes = leaf_gaps(gp, gr), leaf_gaps(cp, cr, moved)
        for what, gaps in (("gradient", grads), ("change", changes)):
            worst = max(gaps, key=gaps.get)
            log(f"{what}: worst leaf {worst} {gaps[worst]!r}, median leaf "
                f"{float(np.median(list(gaps.values())))!r}")
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
            "grad_gap": max(grads.values()),
            "change_gap": max(changes.values()),
        }

    def check(self):
        t = time.perf_counter()
        refr = self.reference()
        gaps = self.compare((self.losses, self.grad_norms, self.change_norms), refr)
        log(f"reference: {time.perf_counter() - t:.1f} s; losses {refr[0]}")
        limits = self.mix["limits"]
        return {k: {"value": v, "limit": limits[k]} for k, v in gaps.items()}

    def close(self):
        pass

    def control(self):
        """The control's numbers: the reference in TF32 in the program's
        place."""
        return self.compare(self.reference(tf32=True), self.reference())

    def faults(self):
        """Each fault's numbers, planted in the reference put in the
        program's place: half of the batch left out (the mean over the
        rest). A state left unchanged reads 1 by the change's measure."""
        return {"half_batch": self.compare(self.reference(half=True), self.reference())}
