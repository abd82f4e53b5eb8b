"""B=1 latency: the step-by-step rollout against the whole-rollout decoder
kernel (counterpart of `scripts/fused_b1_profile.py`).

    python -m zeggs_tpu_torch.profilers.fused_b1_profile [seconds] [--reps 10]

The full v1 model (75 joints, GRU 2 x 1024; `train/loop.py::init_networks`,
seed 0) with the bench fixture's statistics and frame-0 state, on a clip of
``seconds`` (10 by default): the inputs are drawn from
`np.random.default_rng(0)` in the script's order. Lines:

  * ``scan``: the port's compiled step-by-step rollout,
    `infer/programs.py::ProgramCache.rollout` (CUDA graphs of 16, 4 and 1
    decoder steps, GRU1 through the GRU-cell kernel). The programs run
    float32, the GRU-cell kernel's type: the script's bfloat16 XLA scan has
    no captured counterpart, so its bfloat16 numbers come from the eager
    `models/decoder.py::rollout` at bfloat16 compute (``eager-bf16``);
  * ``fused kernel (bf16)`` and ``fused kernel (int8)``: one launch of
    `csrc/decoder_rollout.cu` through `models/decoder.py::make_fused_b1_fn`;
  * each output's MAE against the float32 eager rollout;
  * the weight-streaming bound: the cell's weights read once a step, over
    the H100's 3.35 TB/s.

Each time is the median of ``--reps`` single dispatches after warm-up (the
script chained 10 rollouts a dispatch to hide a TPU link's dispatch cost),
on the host clock closed by `torch.cuda.synchronize`, with the CUDA-event
time beside it. Prints FUSED_B1_PROFILE_DONE last. ``--device cpu --tiny``
rehearses on the CPU at narrow widths (the kernels' plain versions).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bench import fixture as FX
from ..device import HBM_BYTES_PER_S
from ..infer.programs import OUTPUTS, ProgramCache
from ..models import decoder
from ..train.loop import init_networks
from . import common

NAMES = ("root_pos", "root_rot", "lpos", "ltxy")


def inputs(w: FX.Width, T, rng=None):
    """(state0, audio, gaze, style) of one clip of T frames, numpy, drawn
    as the script draws them."""
    rng = np.random.default_rng(0) if rng is None else rng
    state0 = FX._initial_state(rng, 1, w.njoints)
    audio = rng.normal(size=(1, T, FX.AUDIO_DIM)).astype(np.float32)
    gaze = rng.normal(size=(1, T, 3)).astype(np.float32)
    style = rng.normal(size=(1, T, w.options.net.style_encoder.style_encoding_size)
                       ).astype(np.float32)
    return state0, audio, gaze, style


def run(seconds, device, reps, tiny=False):
    T = int(seconds * 60)
    w = FX.width(tiny)
    nets = {k: m.eval().requires_grad_(False) for k, m in
            init_networks(w.options, w.dims, nlabels=19, seed=0, device=device).items()}
    dec = nets["decoder"]
    stats = common.on(device, FX._stats(w.pose_in, w.pose_out))
    pose_stats = (stats["anim_input_mean"], stats["anim_input_std"], stats["anim_output_mean"],
                  stats["anim_output_std"])
    state0, audio, gaze, style = inputs(w, T)
    state0 = common.on(device, state0)
    audio, gaze, style = common.on(device, (audio, gaze, style))
    out = {"seconds": seconds, "frames": T}

    with torch.inference_mode():
        speech = nets["speech_encoder"](audio)
        args = (state0, gaze, speech, style)
        programs = ProgramCache(dec, stats, FX.DT)
        fused = decoder.make_fused_b1_fn(dec, *pose_stats, FX.DT, weights_dtype=torch.bfloat16)
        fused8 = decoder.make_fused_b1_fn(dec, *pose_stats, FX.DT, weights_dtype=torch.int8)

        def picked(o):
            return tuple(o[i] for i in OUTPUTS)

        counts = FX.read_counts()
        out["scan"] = common.timed(lambda: programs.rollout(*args), device, reps)
        out["scan_launches"] = common.launches_since(counts)
        t_scan = out["scan"]["host_ms"]
        print(f"scan (fp32 programs): {common.line(out['scan'])} for {seconds:g}s clip",
              flush=True)
        for key, fn, label in (("fused_bf16", fused, "bf16"), ("fused_int8", fused8, "int8")):
            counts = FX.read_counts()
            out[key] = common.timed(lambda: fn(*args), device, reps)
            out[f"{key}_launches"] = common.launches_since(counts)
            print(f"fused kernel ({label}): {common.line(out[key])}  "
                  f"({t_scan / out[key]['host_ms']:.2f}x)", flush=True)

        ref = decoder.rollout(dec, *state0, gaze, speech, style, *pose_stats, FX.DT,
                              output_indices=OUTPUTS)
        got = {"scan": programs.rollout(*args), "fused": picked(fused(*args)),
               "eager-bf16": decoder.rollout(dec, *state0, gaze, speech, style, *pose_stats,
                                             FX.DT, output_indices=OUTPUTS,
                                             compute_dtype=torch.bfloat16),
               "int8-fused": picked(fused8(*args))}
    out["mae"] = {}
    for i, name in enumerate(NAMES):
        maes = {k: float((g[i].float() - ref[i]).abs().mean()) for k, g in got.items()}
        out["mae"][name] = maes
        print(f"  {name:9s} MAE vs fp32: " + " | ".join(f"{k} {v:.3e}" for k, v in maes.items()),
              flush=True)

    nweights = common.cell_weights(dec)
    bound_ms = 1e3 * (T - 1) * (nweights * 2) / HBM_BYTES_PER_S
    out.update(cell_weights=nweights, bound_bf16_ms=bound_ms, bound_int8_ms=bound_ms / 2)
    print(f"weight-streaming bound ~{bound_ms:.2f} ms bf16 / ~{bound_ms / 2:.2f} ms int8 "
          f"({HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM, H100)", flush=True)
    return out


def main(argv=None):
    ap = common.parser(__doc__.splitlines()[0], reps=10)
    ap.add_argument("seconds", nargs="?", type=float, default=10.0, help="clip length")
    args, device = common.parse(ap, argv)
    out = run(args.seconds, device, args.reps, args.tiny)
    out["device"] = FX.device_summary(device)
    print("FUSED_B1_PROFILE_DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
