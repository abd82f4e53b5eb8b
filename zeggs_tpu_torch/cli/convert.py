"""Checkpoint converter (counterpart of `zeggs_tpu/cli/convert.py`): the
reference's whole-module `.pt` pickles -> native `.npz` parameter trees,
which both packages read.

Usage:
  python -m zeggs_tpu_torch.cli.convert --src <ref>/saved_models --dst ./models
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..io import checkpoint, torch_compat


def main(argv=None):
    p = argparse.ArgumentParser(prog="zeggs_tpu_torch.convert")
    p.add_argument("--src", required=True, help="directory with *.pt whole-module pickles")
    p.add_argument("--dst", required=True, help="output directory for *.npz pytrees")
    p.add_argument("--style-encoding-type", default="example", choices=["example", "label"])
    p.add_argument("--rnn-cond", default="normal", choices=["normal", "film"])
    args = p.parse_args(argv)

    src, dst = Path(args.src), Path(args.dst)
    dst.mkdir(parents=True, exist_ok=True)
    nets = torch_compat.load_reference_networks(src, args.style_encoding_type, args.rnn_cond)
    for name, params in nets.items():
        out = dst / f"{name}.npz"
        checkpoint.save(out, params, meta={"converted_from": str(src / (name + ".pt"))})
        print(f"converted {name}: {out}")
    if not nets:
        p.error(f"no convertible checkpoints found in {src}")


if __name__ == "__main__":
    main()
