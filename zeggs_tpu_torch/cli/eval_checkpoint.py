"""Motion-quality evaluation of a trained checkpoint (counterpart of
`scripts/eval_checkpoint.py`), and the quality gate both packages share.

For every validation clip of the run's processed corpus the trained model
is rolled out over the clip's real audio, with the style of the clip's
leading window (the VAE at mu), and compared with the ground truth:

  * per-joint local velocity and jerk magnitudes (mean, p95): a collapsed
    model reads near zero, a jittery one far above 1x;
  * root-trajectory spread (std of the root position over time);
  * pose MAE (local positions, root position);
  * the per-joint motion-variance ratio (collapse detector).

The first 0.5 s of each rollout (the autoregressive warm-in) are left out
of the statistics and its jerk p95 is reported apart. The gate passes when
the mean velocity ratio lies in [0.5, 2.5], the mean jerk ratio is at most
10 and the median motion-variance ratio is at least 0.25; `main` exits 0
when it passes and 1 when it does not, as the JAX script does.

Run layout, as `Trainer.save_checkpoint` writes it and as the JAX script
reads it: ``root/processed/{data_definition.json, processed_data.npz}`` and
``root/models/<iteration>/{speech_encoder,style_encoder,decoder}.npz``.
Only example-style runs are evaluated: a label-style run has no style
encoder, and `evaluate` raises ValueError on it.

The rollouts of a float32 evaluation replay the rollout programs of
`infer/programs.py` (the counterpart of the JAX script's jitted rollout),
from a cache made for the evaluated checkpoint and dropped with it; on a
card GRU1 of every decoder step is one GRU-cell launch inside their CUDA
graphs (a replay counts its graph's launches, a capture's eager warm-up
step one). A bfloat16 evaluation (``--dtype bfloat16``) runs the eager
`models.decoder.rollout`: the programs are keyed without the compute
type and run float32 only. The default device is
the card (``--device cuda``), and without one the run raises; ``--device
cpu`` replaces the JAX script's ``--cpu``. The JAX script writes its JSON
under the repository's docs/ by default; this one writes
``<root>/eval_<iteration>.json`` unless ``--out`` is given.

    python -m zeggs_tpu_torch.cli.eval_checkpoint --root run_root --iteration 160000
    python -m zeggs_tpu_torch.cli.eval_checkpoint --root run_root --iteration 6 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import Options
from ..data.dataset import WindowedDataset
from ..device import require_device
from ..infer.generate import build_network
from ..infer.programs import ProgramCache
from ..io import checkpoint
from ..models import decoder
from ..train.loop import POSE_KEYS

NETWORKS = ("speech_encoder", "decoder", "style_encoder")


def _mag(x):
    return np.linalg.norm(x, axis=-1)


def _stats(v):
    return {"mean": round(float(np.mean(v)), 5), "p95": round(float(np.percentile(v, 95)), 5)}


def gate(agg):
    """The quality gate: not collapsed (velocity and motion variance not far
    below the ground truth's) and not jittery (jerk at most 10x the ground
    truth's; loose, because the synthetic corpora's ground truth is smooth)."""
    return (0.5 <= agg["vel_ratio_mean"] <= 2.5
            and agg["jerk_ratio_mean"] <= 10.0
            and agg["motion_var_ratio_median"] >= 0.25)


def _load_networks(net_dir, opts, pose_input_size, device):
    if not (net_dir / "style_encoder.npz").exists() and (net_dir / "decoder.npz").exists():
        raise ValueError(
            f"{net_dir} holds no style encoder: a label-style run. The evaluation takes the "
            "style from an example window of each clip and needs an example-style run.")
    return {name: build_network(name, checkpoint.load(net_dir / f"{name}.npz")[0], opts,
                                pose_input_size, device)
            for name in NETWORKS}


def _clip_report(p_root, p_lpos, g_root, g_lpos, dt, label, frames):
    """The statistics of one rollout against its ground truth (numpy)."""
    # skip the autoregressive warm-in: the first frames jump from the
    # first-pose state onto the model's manifold; 0.5 s, clamped so that a
    # short clip keeps at least 4 frames for the third-difference jerk
    warm = min(int(round(0.5 / dt)), max(0, len(p_lpos) - 5))
    jerk_all = _mag(np.diff(p_lpos, n=3, axis=0) * (1.0 / dt) ** 3)
    transient_jerk_p95 = (round(float(np.percentile(jerk_all[:warm], 95)), 2)
                          if warm > 0 and len(jerk_all[:warm]) else None)
    p_root, p_lpos = p_root[warm:], p_lpos[warm:]
    g_root, g_lpos = g_root[warm:], g_lpos[warm:]

    fps = 1.0 / dt
    pv, gv = (_mag(np.diff(x, axis=0) * fps) for x in (p_lpos, g_lpos))
    pj, gj = (_mag(np.diff(x, n=3, axis=0) * fps**3) for x in (p_lpos, g_lpos))
    # per-joint positional variance over time (collapse detector)
    p_var = p_lpos.var(axis=0).mean(-1)
    g_var = g_lpos.var(axis=0).mean(-1)
    moving = g_var > 1e-6
    return {
        "label": label,
        "frames": int(frames),
        "lpos_mae": round(float(np.abs(p_lpos - g_lpos).mean()), 5),
        "root_pos_mae": round(float(np.abs(p_root - g_root).mean()), 5),
        "vel_pred": _stats(pv), "vel_ground": _stats(gv),
        "jerk_pred": _stats(pj), "jerk_ground": _stats(gj),
        "vel_ratio": round(float(pv.mean() / max(gv.mean(), 1e-9)), 4),
        "jerk_ratio": round(float(pj.mean() / max(gj.mean(), 1e-9)), 4),
        "root_spread_pred": round(float(p_root.std(axis=0).mean()), 4),
        "root_spread_ground": round(float(g_root.std(axis=0).mean()), 4),
        "warmin_frames_skipped": warm,
        "warmin_jerk_p95": transient_jerk_p95,
        "motion_var_ratio_median": round(float(np.median(p_var[moving] / g_var[moving])), 4),
    }


@torch.inference_mode()
def evaluate(root, iteration, dtype="float32", device="cuda"):
    """Roll the checkpoint ``root/models/<iteration>`` out over every
    validation clip of ``root/processed`` on ``device`` (the card unless
    the caller asks for the CPU) -> the aggregate report with its
    per-clip entries under "clips". ``dtype`` "bfloat16" runs the decoder
    products in bfloat16."""
    device = require_device(device)
    root = Path(root)
    opts = Options()
    processed = root / "processed"
    ds = WindowedDataset(processed / "data_definition.json", processed / "processed_data.npz",
                         window=opts.train.window,
                         example_length=opts.net.style_encoder.example_length)
    pose_in = ds.get_shapes()["pose_input_size"]
    nets = _load_networks(root / "models" / str(iteration), opts, pose_in, device)
    s = {k: torch.as_tensor(v, device=device) for k, v in ds.stats.items()}
    compute_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    programs = ProgramCache(nets["decoder"], s, ds.dt) if dtype != "bfloat16" else None

    def on_device(a):
        return torch.as_tensor(a, device=device)

    per_clip = []
    for ri in range(len(ds.ranges_valid)):
        sample, label, (a, e), _ = ds.get_sample("valid", range_index=ri)
        audio = (on_device(sample["audio_features"]) - s["audio_input_mean"]) / s[
            "audio_input_std"]
        speech = nets["speech_encoder"](audio)
        # the style of the clip's leading window, the VAE at mu, as
        # Trainer.generate_samples takes it
        vec = ds.get_example(a, a + ds.window, (a, e), 2 * ds.example_length)
        ex = (on_device(vec[None]) - s["anim_input_mean"]) / s["anim_input_std"]
        style = nets["style_encoder"](ex)[0]
        T = speech.shape[1]
        state0 = tuple(on_device(sample[k][:, 0]) for k in POSE_KEYS)
        gaze, style_t = on_device(sample["gaze_pos"]), style[:, None].expand(-1, T, -1)
        if programs is not None:
            out = programs.rollout(state0, gaze, speech, style_t)
            out = (out[0], out[2])  # root_pos, lpos
        else:
            out = decoder.rollout(
                nets["decoder"], *state0, gaze, speech, style_t, s["anim_input_mean"],
                s["anim_input_std"], s["anim_output_mean"], s["anim_output_std"], ds.dt,
                output_indices=(0, 4), compute_dtype=compute_dtype)
        p_root, p_lpos = (o[0].float().cpu().numpy() for o in out)
        per_clip.append(_clip_report(p_root, p_lpos, sample["root_pos"][0], sample["lpos"][0],
                                     ds.dt, ds.label_names[label], e - a))

    return {
        "iteration": iteration,
        "n_valid_clips": len(per_clip),
        "total_frames": int(sum(c["frames"] for c in per_clip)),
        "lpos_mae_mean": round(float(np.mean([c["lpos_mae"] for c in per_clip])), 5),
        "vel_ratio_mean": round(float(np.mean([c["vel_ratio"] for c in per_clip])), 4),
        "jerk_ratio_mean": round(float(np.mean([c["jerk_ratio"] for c in per_clip])), 4),
        "motion_var_ratio_median": round(float(np.median(
            [c["motion_var_ratio_median"] for c in per_clip])), 4),
        "clips": per_clip,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zeggs_tpu_torch.eval_checkpoint",
                                 description="Motion-quality evaluation of a checkpoint")
    ap.add_argument("--root", type=str, required=True,
                    help="run root: processed/ and models/<iteration>/")
    ap.add_argument("--iteration", type=int, default=160000)
    ap.add_argument("--out", type=str, default=None,
                    help="report path (default: <root>/eval_<iteration>.json)")
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    agg = evaluate(Path(args.root), args.iteration, dtype=args.dtype, device=args.device)
    out = Path(args.out or Path(args.root) / f"eval_{args.iteration}.json")
    out.write_text(json.dumps(agg, indent=1))
    print(f"wrote {out}", file=sys.stderr)
    ok = gate(agg)
    print(json.dumps({k: agg[k] for k in agg if k != "clips"} | {"not_collapsed_not_jittery": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
