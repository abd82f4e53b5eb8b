"""The training recipe through the KL anneal and beyond (counterpart of
`scripts/train_anneal.py`).

The KL weight's schedule centres at iteration 7500 (cap 0.2) and the
learning rate decays x0.995 every 1000 iterations, so a short curve sees
neither. This CLI runs the full v1 recipe (batch 32 x 256-frame windows,
RAdam, the 18-term loss, seed 1234) for ``--iters`` iterations (10,000 by
default) on the synthetic corpus (6 clips of 8 s,
`data/synthetic.py::build_corpus`, built in this process on the run's
device), logging the total loss, the weighted KL term, two reconstruction
terms and the KL weight every ``--log-every`` iterations, and checks
(`checks`):

  * every logged value is finite (no divergence through the anneal);
  * the tail (mean of the last 100 logged losses) is below 0.6 x the head
    (the first 10);
  * the tail is below 2 x the pre-anneal floor (the 50 logged losses before
    the middle of the run) + 0.25: no blow-up after the anneal.

    python -m zeggs_tpu_torch.cli.train_anneal --iters 10000

Writes the schema of `docs/anneal_curve.json` (the same keys in the same
order) to ``--out`` (by default ``<root>/anneal_curve.json``; ``--root``
defaults to ``runs/anneal`` under the working directory and holds the
corpus and the checkpoint of iteration 0). Exits 1 when a check fails. The
default device is the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ..data.synthetic import build_corpus
from ..device import require_device
from ..train.loop import Trainer
from . import train_full

LOG_KEYS = ("total_loss", "loss_kl_div", "loss_lpos", "loss_lrot")
KL_CENTER = 7500
PRINT_EVERY = 500


def _mean(a):
    return float(np.mean(a)) if len(a) else float("nan")


def readings(curve):
    """(head, pre-anneal floor, tail) of the logged total losses, sliced as
    the JAX script slices them."""
    tot = np.asarray(curve["total_loss"], np.float64)
    n = len(tot)
    return _mean(tot[:10]), _mean(tot[n // 2 - 50 : n // 2]), _mean(tot[-100:])


def checks(curve):
    """The script's three checks on a curve -> the failed ones (empty:
    stable through the anneal). A NaN reading fails."""
    values = np.concatenate([np.asarray(curve[k], np.float64) for k in (*LOG_KEYS, "kl_weight")])
    head, floor, tail = readings(curve)
    failed = []
    if not np.isfinite(values).all():
        failed.append("non-finite value in training curve")
    if not tail < 0.6 * head:
        failed.append("loss did not decrease materially over the run")
    if not tail < 2.0 * floor + 0.25:
        failed.append("post-anneal loss blew up relative to the pre-anneal floor")
    return failed


def run(processed, iters, log_every, dtype, device):
    """The recipe (`train_full.recipe_options`) for ``iters`` iterations ->
    (curve lists by key, the logged iterations)."""
    processed = Path(processed)
    curve = {k: [] for k in LOG_KEYS}
    curve["kl_weight"] = []
    iters_logged = []
    t_start = time.time()

    def on_step(i, m):
        if i % log_every:
            return
        iters_logged.append(i)
        for k in LOG_KEYS:
            curve[k].append(float(m[k]))
        curve["kl_weight"].append(train_full.kl_weight(i))
        if i % PRINT_EVERY == 0:
            print(f"iter {i}: total={curve['total_loss'][-1]:.4f} "
                  f"kl={curve['loss_kl_div'][-1]:.5f} w={curve['kl_weight'][-1]:.4f} "
                  f"({time.time() - t_start:.0f}s)", flush=True)

    with tempfile.TemporaryDirectory(dir=processed.parent, prefix="run_") as td:
        trainer = Trainer(train_full.recipe_options(dtype, 10**9), Path(td) / "m",
                          Path(td) / "l", processed / "processed_data.npz",
                          processed / "data_definition.json", device=device)
        trainer.generate_samples = lambda *a, **k: None  # curve run only
        trainer.run(max_iterations=iters, log_every=10**9, on_step=on_step)
    return curve, iters_logged


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zeggs_tpu_torch.train_anneal",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10_000)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--root", type=str, default="runs/anneal",
                    help="the corpus and the run (default: runs/anneal under the working "
                         "directory)")
    ap.add_argument("--out", type=str, default=None,
                    help="curve JSON (default: <root>/anneal_curve.json)")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)  # before anything is written: no fall-back

    root = Path(args.root)
    processed = root / "processed"
    if not (processed / "processed_data.npz").exists():
        build_corpus(root, device=device)
    t0 = time.time()
    curve, iters_logged = run(processed, args.iters, args.log_every, args.dtype, device)
    wall_s = time.time() - t0

    out = Path(args.out) if args.out else root / "anneal_curve.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "iters": args.iters, "log_every": args.log_every,
        "dtype": args.dtype, "kl_center": KL_CENTER, "iters_logged_len": len(iters_logged),
        **curve,
    }))
    print(f"wrote {out} ({wall_s:.1f} s of training)")

    head, floor, tail = readings(curve)
    print(f"loss: start {head:.3f} -> mid {floor:.3f} -> tail {tail:.3f}; "
          f"kl weight final {curve['kl_weight'][-1]:.3f}")
    failed = checks(curve)
    if failed:
        print(f"FAILED: {'; '.join(failed)}", flush=True)
        return 1
    print("full schedule stable through the KL anneal. OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
