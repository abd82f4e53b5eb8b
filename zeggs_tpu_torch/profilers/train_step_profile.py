"""Where the train step's time goes: the forward loss alone, and the whole
bfloat16 step eagerly and replayed (counterpart of
`scripts/train_step_profile.py`).

    python -m zeggs_tpu_torch.profilers.train_step_profile [fwd|bf16|all ...] [--reps 4]

On the script's batch (`batch_of(32, 256)`: `np.random.default_rng(0)`,
drawn in its order, 75 joints) with the full v1 networks (seed 0):

  * ``fwd``: the float32 loss forward (`train/loop.py::make_loss_fn`, with
    dropout from a generator seeded 0, at iteration 0) as a training step
    runs it, autograd recording: eagerly and as a CUDA-graph replay with
    its kernel count;
  * ``bf16``: the whole step at bfloat16 compute through the eager
    `train/loop.py::make_train_step` and through the
    `train/programs.py::TrainProgram` replay (the script's step over a
    one-device mesh has no other counterpart).

Prints PROFILE_DONE last. ``--device cpu --tiny`` rehearses on the CPU at 8
joints and narrow widths (eager only).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bench import fixture as FX
from ..config import Options, TrainConfig
from ..train import loop
from . import common

SECTIONS = ("all", "fwd", "bf16")


def batch_of(B, T, J=FX.NJOINTS, pose_in=FX.POSE_IN):
    """The script's batch of B windows of T frames (numpy, its draws in its
    order)."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, T, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return {
        "audio_features": rng.normal(size=(B, T, FX.AUDIO_DIM)).astype(np.float32),
        "root_pos": rng.normal(size=(B, T, 3)).astype(np.float32),
        "root_rot": q,
        "root_vel": rng.normal(size=(B, T, 3)).astype(np.float32) * 0.1,
        "root_vrt": rng.normal(size=(B, T, 3)).astype(np.float32) * 0.1,
        "lpos": rng.normal(size=(B, T, J, 3)).astype(np.float32),
        "ltxy": rng.normal(size=(B, T, J, 2, 3)).astype(np.float32),
        "lvel": rng.normal(size=(B, T, J, 3)).astype(np.float32) * 0.1,
        "lvrt": rng.normal(size=(B, T, J, 3)).astype(np.float32) * 0.1,
        "gaze_pos": rng.normal(size=(B, T, 3)).astype(np.float32),
        "example": rng.normal(size=(B, 512, pose_in)).astype(np.float32),
        "example_lengths": np.full(B, 256, np.int32),
    }


def run(which, device, reps, tiny=False):
    B, T, J, w = common.shapes(tiny)
    batch_np = batch_of(B, T, J, w.pose_in)
    batch = common.on(device, batch_np)
    stats = FX._stats(w.pose_in, w.pose_out)
    parents = [-1] + list(range(J - 1))
    out = {}

    if {"fwd", "all"} & set(which):
        opts = Options(net=w.options.net)
        nets = loop.init_networks(opts, w.dims, nlabels=19, seed=0, device=device)
        loss_fn = loop.make_loss_fn(opts, stats, parents, FX.DT)
        zero, gen = torch.zeros((), device=device), torch.Generator(device=device)
        gen.manual_seed(0)
        out["fwd"] = common.section("fwd-only loss (fp32)",
                                    lambda: loss_fn(nets, batch, zero, gen)[0], device, reps, gen)
        del nets

    if {"bf16", "all"} & set(which):
        opts16 = Options(net=w.options.net, train=TrainConfig(compute_dtype="bfloat16"))
        out["bf16"] = common.step_variants("full step (bf16) eager", "full step (bf16) replay",
                                           opts16, w, stats, parents, batch_np, device, reps)
    return out


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0], SECTIONS, reps=4)
    args, device = common.parse(ap, argv)
    before = FX.read_counts()
    out = run(args.which, device, args.reps, args.tiny)
    out["launches"] = common.launches_since(before)
    out["device"] = FX.device_summary(device)
    print("PROFILE_DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
