"""The training forward pass broken into pieces, each timed on the card
(counterpart of `scripts/loss_profile.py`).

    python -m zeggs_tpu_torch.profilers.loss_profile [loss|fk|rollout|all ...] [--reps 10]

At B=32, T=256, J=75 on the script's seeded arrays (`np.random.
default_rng(0)`, drawn in its order): ``loss`` is `train/loss.py::
compute_loss` forward with outputs = targets, ``fk`` the loss's matrix FK
`ops/fk.py::xform_fk_vel` forward, ``rollout`` the float32 decoder rollout
forward (`models/decoder.py::rollout` over the full v1 decoder, seed 0, GRU1
through the GRU-cell kernel). Each is timed eagerly and as a CUDA-graph
replay, with the graph's kernel count (`common.section`). Prints
LOSSPROFILE_DONE last. ``--device cpu --tiny`` rehearses on the CPU at 8
joints and narrow widths (eager only).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bench import fixture as FX
from ..models import decoder
from ..ops import fk, quat
from ..train.loop import POSE_KEYS, init_networks
from ..train.loss import compute_loss
from . import common

SECTIONS = ("all", "loss", "fk", "rollout")


def run(which, device, reps, tiny=False):
    """The sections of ``which`` (a list of SECTIONS) -> {section: times}."""
    B, T, J, w = common.shapes(tiny)
    rng = np.random.default_rng(0)
    q, W, gaze = common.pose_targets(rng, B, T, J)
    Wt, gaze_t = common.on(device, W), torch.as_tensor(gaze, device=device)
    parents = [-1] + list(range(J - 1))
    out = {}

    def wants(name):
        return name in which or "all" in which

    with torch.inference_mode():
        if wants("loss"):
            out["loss"] = common.section(
                "full compute_loss fwd",
                lambda: compute_loss(Wt, Wt, gaze_t, parents, FX.DT)[0], device, reps)
        if wants("fk"):
            lmat = quat.to_xform(quat.normalize(Wt["root_rot"]))[:, :, None].repeat(1, 1, J, 1, 1)
            out["fk"] = common.section(
                "xform_fk_vel fwd",
                lambda: fk.xform_fk_vel(lmat, Wt["lpos"], Wt["lvrt"], Wt["lvel"],
                                        parents)[1].sum(), device, reps)
        if wants("rollout"):
            nets = init_networks(w.options, w.dims, nlabels=19, seed=0, device=device)
            speech, style = common.on(device, common.encodings(rng, B, T, w.options.net))
            stats = common.on(device, FX._stats(w.pose_in, w.pose_out))
            s0 = tuple(Wt[k][:, 0] for k in POSE_KEYS)
            out["rollout"] = common.section(
                "decoder rollout fwd fp32",
                lambda: decoder.rollout(
                    nets["decoder"], *s0, gaze_t, speech, style, stats["anim_input_mean"],
                    stats["anim_input_std"], stats["anim_output_mean"],
                    stats["anim_output_std"], FX.DT)[0].sum(), device, reps)
    return out


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0], SECTIONS, reps=10)
    args, device = common.parse(ap, argv)
    before = FX.read_counts()
    out = run(args.which, device, args.reps, args.tiny)
    out["launches"] = common.launches_since(before)
    out["device"] = FX.device_summary(device)
    print("LOSSPROFILE_DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
