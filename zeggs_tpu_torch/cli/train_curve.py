"""The training recipe's short loss curve at float32 and bfloat16
(counterpart of `scripts/train_curve.py`).

Runs the full recipe (the 18-term loss, the KL anneal, RAdam and the ExpLR
schedule at v1 widths: batch 32 x 256-frame windows, seed 1234) for
``--iters`` iterations at float32 and then at bfloat16 on the synthetic
corpus (6 clips of 8 s, `data/synthetic.py::build_corpus`), and shows that
the recipe learns and that bfloat16 compute tracks float32 (`verdict`):

  * the float32 tail (mean of the last 50 losses) is below half its head
    (mean of the first 10);
  * the bfloat16 tail is within 15% of the float32 tail.

    python -m zeggs_tpu_torch.cli.train_curve --iters 400

Writes ``{iters, float32, bfloat16}``, the schema of `docs/loss_curve.json`,
to ``--out`` (by default ``<root>/loss_curve.json``; ``--root`` defaults to
``runs/curve`` under the working directory and holds the corpus and each
run's checkpoint at iteration 0). Exits 1 when the verdict fails. The
default device is the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

from ..data.synthetic import build_corpus
from ..device import require_device
from ..train.loop import Trainer
from . import train_full

DTYPES = ("float32", "bfloat16")
HEAD, TAIL = 10, 50  # losses averaged at the start and at the end


def run(processed, dtype, iters, device):
    """``iters`` recipe iterations at ``dtype`` on the processed corpus
    (`train_full.recipe_options`, no sample synthesis after iteration 0) ->
    the total loss of each iteration. The checkpoint and samples of
    iteration 0 go to a temporary directory beside the corpus."""
    processed = Path(processed)
    losses = []
    with tempfile.TemporaryDirectory(dir=processed.parent, prefix=f"run_{dtype}_") as td:
        trainer = Trainer(train_full.recipe_options(dtype, 10**9), Path(td) / "m",
                          Path(td) / "l", processed / "processed_data.npz",
                          processed / "data_definition.json", device=device)
        trainer.run(max_iterations=iters,
                    on_step=lambda i, m: losses.append(float(m["total_loss"])))
    return losses


def head_tail(curve):
    return float(np.mean(curve[:HEAD])), float(np.mean(curve[-TAIL:]))


def verdict(curves):
    """The script's two checks on ``{"float32": [...], "bfloat16": [...]}``
    -> the failed ones (empty: the recipe learns and bfloat16 tracks
    float32). A NaN fails both."""
    head, f32_tail = head_tail(curves["float32"])
    _, bf_tail = head_tail(curves["bfloat16"])
    failed = []
    if not f32_tail < 0.5 * head:
        failed.append("fp32 loss did not decrease materially")
    if not abs(bf_tail - f32_tail) / f32_tail < 0.15:
        failed.append("bf16 diverges from fp32")
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zeggs_tpu_torch.train_curve",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--root", type=str, default="runs/curve",
                    help="the corpus and the runs (default: runs/curve under the working "
                         "directory)")
    ap.add_argument("--out", type=str, default=None,
                    help="curve JSON (default: <root>/loss_curve.json)")
    ap.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)  # before anything is written: no fall-back

    root = Path(args.root)
    processed = root / "processed"
    if not (processed / "processed_data.npz").exists():
        build_corpus(root, device=device)

    curves = {}
    for dtype in DTYPES:
        curves[dtype] = run(processed, dtype, args.iters, device)
        head, tail = head_tail(curves[dtype])
        print(f"{dtype}: loss {head:.3f} -> {tail:.3f} ({tail / head:.2%} of start) over "
              f"{args.iters} iters", flush=True)

    out = Path(args.out) if args.out else root / "loss_curve.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"iters": args.iters, **curves}))
    print(f"wrote {out}")

    failed = verdict(curves)
    if failed:
        print(f"FAILED: {'; '.join(failed)}", flush=True)
        return 1
    print("recipe learns; bf16 tracks fp32. OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
