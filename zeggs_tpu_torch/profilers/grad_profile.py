"""The gradients of each training sub-graph, timed separately on the card
(counterpart of `scripts/grad_profile.py`).

    python -m zeggs_tpu_torch.profilers.grad_profile [all|all2|all3|all4|<section> ...]

At B=32, T=256, J=75, on the script's seeded arrays (`np.random.
default_rng(0)`, drawn in its order: the module's draws, then each
section's) and the full v1 networks (seed 0). The sections and their
groups are the script's:

  * ``all``: ``rollgrad`` (the gradient of the decoder rollout's L2 with
    respect to the decoder, float32), ``lossgrad`` (of `compute_loss` with
    respect to the outputs), ``stylegrad`` (of the style encoder's
    embedding L2, 512-frame examples of 256 frames);
  * ``all2``: ``fullgrad`` (the full loss, `train/loop.py::make_loss_fn`,
    and its gradients, with dropout) and ``fullgrad_nodrop`` (the same with
    no dropout and the style embedding = mu: the port's deterministic loss;
    the script kept the VAE noise);
  * ``all3``: ``dropgrad`` (the full loss's gradients with dropout) and
    ``raw_rng`` (`torch.bernoulli` at p 0.9 over (32, 4, 512, 512) from a
    `torch.Generator` on the card: Philox, where the script's JAX draws
    threefry);
  * ``all4``: ``stepvariants``, the whole train step in the port's two
    forms: the eager `train/loop.py::make_train_step` and the
    `train/programs.py::TrainProgram` replay (the script's variants, a mesh
    and buffer donation, have no counterpart).

Every section but ``stepvariants`` is timed eagerly and as a CUDA-graph
replay with its kernel count (`common.section`; a failed capture raises).
Prints GRADPROFILE_DONE last. ``--device cpu --tiny`` rehearses on the CPU
at 8 joints and narrow widths (eager only).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bench import fixture as FX
from ..models import decoder
from ..train import loop
from ..train.loss import compute_loss
from . import common

SECTIONS = ("all", "all2", "all3", "all4", "rollgrad", "lossgrad", "stylegrad", "fullgrad",
            "fullgrad_nodrop", "dropgrad", "raw_rng", "stepvariants")
GROUPS = {"all": ("rollgrad", "lossgrad", "stylegrad"),
          "all2": ("fullgrad", "fullgrad_nodrop"),
          "all3": ("dropgrad", "raw_rng"),
          "all4": ("stepvariants",)}


def wanted(which):
    """The sections ``which`` names, groups expanded."""
    return {s for w in which for s in GROUPS.get(w, (w,))}


class Setup:
    """The script's module-level state: targets, gaze, networks, statistics,
    speech and style encodings and the frame-0 state."""

    def __init__(self, device, tiny):
        B, T, J, w = common.shapes(tiny)
        self.B, self.T, self.J, self.w, self.device = B, T, J, w, device
        self.rng = np.random.default_rng(0)
        _, W, gaze = common.pose_targets(self.rng, B, T, J)
        self.W_np, self.gaze_np = W, gaze
        self.W, self.gaze = common.on(device, W), torch.as_tensor(gaze, device=device)
        self.parents = [-1] + list(range(J - 1))
        self.stats_np = FX._stats(w.pose_in, w.pose_out)
        self.stats = common.on(device, self.stats_np)
        self.nets = loop.init_networks(w.options, w.dims, nlabels=19, seed=0, device=device)
        self.speech, self.style = common.on(device, common.encodings(self.rng, B, T,
                                                                      w.options.net))
        self.s0 = tuple(self.W[k][:, 0] for k in loop.POSE_KEYS)

    def batch(self):
        """A training batch: the targets and gaze, then new audio features
        and 2T-frame examples of T frames drawn from the module's generator
        (each of the script's full-loss sections draws its own) -> numpy."""
        B, T = self.B, self.T
        audio = self.rng.normal(size=(B, T, FX.AUDIO_DIM)).astype(np.float32)
        example = self.rng.normal(size=(B, 2 * T, self.w.pose_in)).astype(np.float32)
        return {**self.W_np, "audio_features": audio, "gaze_pos": self.gaze_np,
                "example": example, "example_lengths": np.full(B, T, np.int32)}

    def generator(self):
        g = torch.Generator(device=self.device)
        g.manual_seed(0)
        return g


def _grads(loss, params):
    return torch.autograd.grad(loss, params)


def run(which, device, reps, tiny=False):
    """The sections of ``which`` -> {section: times}."""
    todo = wanted(which)
    S = Setup(device, tiny)
    out = {}
    dec = S.nets["decoder"]
    zero = torch.zeros((), device=device)

    if "rollgrad" in todo:
        params = list(dec.parameters())

        def rollgrad():
            outs = decoder.rollout(dec, *S.s0, S.gaze, S.speech, S.style,
                                   S.stats["anim_input_mean"], S.stats["anim_input_std"],
                                   S.stats["anim_output_mean"], S.stats["anim_output_std"],
                                   FX.DT)
            return _grads(sum(torch.sum(o**2) for o in outs), params)

        out["rollgrad"] = common.section("grad(rollout L2) fp32", rollgrad, device, reps)

    if "lossgrad" in todo:
        O = {k: v.clone().requires_grad_(True) for k, v in S.W.items()}
        out["lossgrad"] = common.section(
            "grad(compute_loss wrt outputs)",
            lambda: _grads(compute_loss(O, S.W, S.gaze, S.parents, FX.DT)[0], list(O.values())),
            device, reps)

    if "stylegrad" in todo:
        B, T = S.B, S.T
        ex = torch.as_tensor(S.rng.normal(size=(B, 2 * T, S.w.pose_in)).astype(np.float32),
                             device=device)
        lens = torch.full((B,), T, dtype=torch.int32, device=device)
        style_encoder = S.nets["style_encoder"]
        params = list(style_encoder.parameters())

        def stylegrad():
            emb, _, _ = style_encoder(ex, lengths=lens, train=False)
            return _grads(torch.sum(emb**2), params)

        out["stylegrad"] = common.section("grad(style encoder)", stylegrad, device, reps)

    params = [p for m in S.nets.values() for p in m.parameters()]

    def full_loss(deterministic, name, label, value):
        loss_fn = loop.make_loss_fn(S.w.options, S.stats_np, S.parents, FX.DT, deterministic)
        batch = common.on(device, S.batch())
        generator = None if deterministic else S.generator()

        def fn():
            loss = loss_fn(S.nets, batch, zero, generator)[0]
            grads = _grads(loss, params)
            return (loss, grads) if value else grads

        out[name] = common.section(label, fn, device, reps, generator)

    if "fullgrad" in todo:
        full_loss(False, "fullgrad", "value_and_grad(full loss_fn)", True)
    if "fullgrad_nodrop" in todo:
        full_loss(True, "fullgrad_nodrop", "value_and_grad(no dropout)", True)
    if "dropgrad" in todo:
        full_loss(False, "dropgrad", "grad(full loss_fn WITH dropout, Philox)", False)

    if "raw_rng" in todo:
        shape = (4, 4, 64, 64) if tiny else (32, 4, 512, 512)
        generator = S.generator()
        probs = torch.full(shape, 0.9, device=device)
        out["raw_rng"] = common.section(
            f"bernoulli {shape} Philox (torch.Generator)",
            lambda: torch.bernoulli(probs, generator=generator).sum(), device, reps, generator)

    if "stepvariants" in todo:
        out["stepvariants"] = common.step_variants(
            "step eager (make_train_step)", "step replay (TrainProgram)", S.w.options, S.w,
            S.stats_np, S.parents, S.batch(), device, reps)
    return out


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0], SECTIONS, reps=5)
    args, device = common.parse(ap, argv)
    before = FX.read_counts()
    out = run(args.which, device, args.reps, args.tiny)
    out["launches"] = common.launches_since(before)
    out["device"] = FX.device_summary(device)
    print("GRADPROFILE_DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
