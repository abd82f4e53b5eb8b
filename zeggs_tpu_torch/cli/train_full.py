"""The full v1 training recipe, run for real (counterpart of
`scripts/train_full.py`).

The recipe trains 160k iterations: batch 32 x 256-frame windows, RAdam lr
1e-4, ExpLR x0.995 every 1000 iterations, the KL anneal centred at 7500
with cap 0.2, and a checkpoint with 3 train / 3 validation ground/predict
sample clips every ``--ckpt-every`` iterations (configs/configs_v1.json).
This CLI runs the schedule on the synthetic corpus of `build_corpus` (6
clips of 8 s through `data.pipeline`) and records:

  * all 18 loss terms and the weighted KL and total, every ``--log-every``
    iterations, with the KL weight and the ExpLR scale there;
  * checkpoints and sample BVH pairs every ``--ckpt-every`` iterations;
  * the wall time.

Everything the run writes goes under ``--root`` (by default ``runs/full``
under the working directory). The curve JSON (``--out``, by default
``<root>/full_run_curve.json``) has the JAX script's schema and is
rewritten every 1000 iterations, so a partial run still leaves it; a
``--max-hours`` budget stops the run with a checkpoint and the curve marked
``completed: false``; with the same ``--root`` the next run resumes from
the latest checkpoint and merges the curve (`main`'s ``preload_curve``).

    python -m zeggs_tpu_torch.cli.train_full --iters 2000 --dtype float32 \\
        --root runs/full --log-every 100 --ckpt-every 1000
    python -m zeggs_tpu_torch.cli.eval_checkpoint --root runs/full --iteration 2000

The default device is the card; ``--device cpu`` runs on the CPU (the
tests replace `recipe_options` with narrow widths there).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import NetworkConfig, Options, TrainConfig
from ..data.synthetic import build_corpus, write_raw_corpus  # noqa: F401 (the CLI's corpus)
from ..device import require_device
from ..train.loop import Trainer
from ..train.loss import generalized_logistic_function

TERM_KEYS = (
    "total_loss", "loss_kl_div",
    "loss_root_pos", "loss_root_rot", "loss_root_vel", "loss_root_vrt",
    "loss_lpos", "loss_lrot", "loss_lvel", "loss_lvrt",
    "loss_cpos", "loss_crot", "loss_cvel", "loss_cvrt",
    "loss_ldvl", "loss_ldvt", "loss_cdvl", "loss_cdvt",
    "loss_gaze",
)
RECIPE = ("configs_v1 (batch 32 x 256, RAdam 1e-4, ExpLR 0.995/1k, "
          "KL center 7500 cap 0.2)")
#: iterations between rewrites of the curve file
FLUSH_EVERY = 1000

# -- the run --------------------------------------------------------------------

class TimeBudgetExceeded(Exception):
    pass


def recipe_options(dtype, ckpt_every):
    """The recipe's options: full v1 widths, batch 32 x 256, resuming."""
    return Options(
        net=NetworkConfig(),
        train=TrainConfig(batchsize=32, window=256, seed=1234, compute_dtype=dtype,
                          generate_samples_step=ckpt_every, use_tensorboard=False, resume=True),
    )


def kl_weight(i):
    """The weight of the KL term at iteration ``i`` (`train.loss.kl_divergence`)."""
    return min(float(generalized_logistic_function(torch.tensor(i, dtype=torch.float32),
                                                   center=7500.0, growth=0.005)), 0.2)


def pin_sample_example_length(trainer):
    """Sample synthesis draws an example-window length per clip; pin it to
    the longest legal length (2 x example_length), as
    `scripts/train_full.py` does, where every new length costs a compile.
    The port's style encoder runs eagerly, so here the pin only keeps the
    synthesis draws equal to that script's. Training is untouched."""
    orig_gen = trainer.generate_samples
    fixed = 2 * trainer.ds.example_length

    def gen(n=3, length_s=30):
        orig_sel = trainer.ds.sample_example_length
        trainer.ds.sample_example_length = lambda rng: fixed
        try:
            return orig_gen(n, length_s)
        finally:
            trainer.ds.sample_example_length = orig_sel

    trainer.generate_samples = gen


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zeggs_tpu_torch.train_full",
                                 description="Run the full v1 training recipe")
    ap.add_argument("--iters", type=int, default=160_000)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--ckpt-every", type=int, default=10_000)
    ap.add_argument("--dtype", type=str, default="bfloat16")
    ap.add_argument("--max-hours", type=float, default=5.0)
    ap.add_argument("--root", type=str, default="runs/full",
                    help="the run's corpus, checkpoints and curve (default: runs/full under "
                         "the working directory)")
    ap.add_argument("--out", type=str, default=None,
                    help="curve JSON (default: <root>/full_run_curve.json)")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    require_device(args.device)  # before anything is written: no fall-back to the CPU

    root = Path(args.root)
    processed = root / "processed"
    if not (processed / "processed_data.npz").exists():
        build_corpus(root, device=args.device)
    opts = recipe_options(args.dtype, args.ckpt_every)

    out_path = Path(args.out) if args.out else root / "full_run_curve.json"
    curve = {k: [] for k in TERM_KEYS}
    curve["kl_weight"] = []
    curve["lr_scale"] = []
    iters_logged = []

    def preload_curve(start_iter):
        """On resume, merge the previous run's curve, so that a crash never
        loses history. Points from the resumed iteration on are trimmed:
        the old file may run ahead of the restored state (it flushes every
        1000 iterations, checkpoints come every --ckpt-every), and the
        resumed run logs its first iteration again (the JAX script keeps
        that point, so its merged curve holds it twice)."""
        if start_iter <= 0 or not out_path.exists():
            return
        try:
            prev = json.loads(out_path.read_text())
        except (json.JSONDecodeError, OSError):
            return
        prev_iters = prev.get("iters_logged", [])
        keep = sum(1 for i in prev_iters if i < start_iter)
        # validate before merging: a file with schema drift (missing keys,
        # short lists) is ignored as a whole, not merged halfway
        if not keep or any(not isinstance(prev.get(k), list) or len(prev[k]) < keep
                           for k in curve):
            return
        iters_logged.extend(prev_iters[:keep])
        for k in curve:
            curve[k].extend(prev[k][:keep])
        state["wall_offset"] = float(prev.get("wall_s", 0.0))
        print(f"merged {keep} prior curve points (through iter {iters_logged[-1]}) from "
              f"{out_path}", flush=True)

    t_start = time.time()
    state = {"wall_offset": 0.0}
    budget_s = args.max_hours * 3600.0

    def flush(completed, final_iter):
        elapsed = time.time() - t_start + state["wall_offset"]
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({
            "recipe": RECIPE,
            "iters_target": args.iters, "iters_done": final_iter,
            "log_every": args.log_every, "ckpt_every": args.ckpt_every,
            "dtype": args.dtype, "completed": completed,
            "wall_s": elapsed, "iters_per_s": (final_iter or 0) / max(elapsed, 1e-9),
            "iters_logged": iters_logged,
            **curve,
        }))

    def on_step(i, m):
        if i % args.log_every == 0:
            iters_logged.append(i)
            for k in TERM_KEYS:
                curve[k].append(float(m[k]))
            curve["kl_weight"].append(kl_weight(i))
            curve["lr_scale"].append(0.995 ** (i // 1000))
        el = time.time() - t_start
        if i % FLUSH_EVERY == 0:
            flush(False, i)
            rate = (i - state["start_iter"]) / max(el, 1e-9)
            eta_h = (args.iters - i) / max(rate, 1e-9) / 3600 if i else float("nan")
            if curve["total_loss"]:  # empty when --log-every > 1000
                print(f"iter {i}/{args.iters}: total={curve['total_loss'][-1]:.4f} "
                      f"kl_w={curve['kl_weight'][-1]:.3f} lr={curve['lr_scale'][-1]:.3f} "
                      f"({el:.0f}s, {rate:.1f} it/s, eta {eta_h:.2f}h)", flush=True)
        if el > budget_s:
            raise TimeBudgetExceeded(f"{el:.0f}s > {budget_s:.0f}s at iter {i}")

    trainer = Trainer(opts, root / "models", root / "logs", processed / "processed_data.npz",
                      processed / "data_definition.json", device=args.device)
    pin_sample_example_length(trainer)
    start_iter = trainer.iteration
    state["start_iter"] = start_iter
    if start_iter:
        print(f"resuming from iteration {start_iter}", flush=True)
        preload_curve(start_iter)

    try:
        trainer.run(max_iterations=args.iters, log_every=10**9, on_step=on_step)
        # the in-loop checkpoint comes at N % ckpt_every == 0 before the
        # iteration's increment, so the final state needs a save of its own
        trainer.save_checkpoint()
        completed = True
    except TimeBudgetExceeded as e:
        # Trainer.run checkpointed before re-raising
        print(f"time budget hit: {e}; checkpointed, curve marked partial", flush=True)
        completed = False

    final_iter = trainer.iteration
    flush(completed, final_iter)
    wall_h = (time.time() - t_start + state["wall_offset"]) / 3600
    print(f"wrote {out_path} ({final_iter} iters, {wall_h:.2f}h wall, completed={completed})",
          flush=True)

    vals = np.concatenate([np.asarray(curve[k]) for k in curve if curve[k]])
    assert np.isfinite(vals).all(), "non-finite value in training curve"
    tot = np.asarray(curve["total_loss"])
    if completed and len(tot) > 200:
        head = float(tot[:10].mean())
        floor = float(tot.min())
        tail = float(tot[-len(tot) // 16:].mean())
        print(f"loss: start {head:.3f} -> min {floor:.3f} -> tail {tail:.3f}; final lr scale "
              f"{curve['lr_scale'][-1]:.3f} ({(final_iter - start_iter) // 1000} decays this "
              "run)")
        assert tail < 0.6 * head, "loss did not decrease materially over the run"
        assert tail < 2.0 * floor + 0.25, "post-anneal tail blew up against the run's floor"
        print(f"full recipe executed: {wall_h:.2f}h measured wall. OK")
    return trainer


if __name__ == "__main__":
    main()
