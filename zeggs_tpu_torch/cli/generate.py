"""Inference CLI: one audio/style pair or a CSV of them (counterpart of
`zeggs_tpu/cli/generate.py`, with the same flags plus ``--device``).

Usage:
  python -m zeggs_tpu_torch.cli.generate -o options.json -s style.bvh -a audio.wav
  python -m zeggs_tpu_torch.cli.generate -o options.json -c evaluation.csv
  python -m zeggs_tpu_torch.cli.generate -o options.json -c evaluation.csv -b --int8
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path

from ..config import Options
from ..infer import GesturePipeline, generate_gesture
from ..infer.batch import Request, generate_batch


def build_parser():
    p = argparse.ArgumentParser(prog="zeggs_tpu_torch.generate", description="Generate gestures")
    p.add_argument("-o", "--options", type=str, required=True, help="options.json from training")
    p.add_argument("-p", "--results_path", type=str, nargs="?", const=None, required=False)
    p.add_argument("-se", "--style_encoding_type", type=str, default="example")
    p.add_argument("-s", "--style", type=str, required=False)
    p.add_argument("-a", "--audio", type=str, required=False)
    p.add_argument("-n", "--file_name", type=str, required=False)
    p.add_argument("-fp", "--first_pose", type=str, default=None, required=False)
    p.add_argument("-t", "--temperature", type=float, nargs="?", default=1.0)
    p.add_argument("-r", "--seed", type=int, nargs="?", default=1234)
    p.add_argument("-g", "--use_gpu", action="store_true",
                   help="accepted for parity with the reference CLI; --device chooses")
    p.add_argument("-f", "--frames", type=int, nargs=2, required=False)
    p.add_argument("-c", "--csv", type=str, required=False)
    p.add_argument("-b", "--batch", action="store_true",
                   help="CSV mode: bucket the clips by length into batched rollouts")
    p.add_argument("--int8", action="store_true",
                   help="int8 decoder weights in B=1 rollouts, and int8 products in batched "
                   "rollouts of 256 clips or more")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def _rel(base, name):
    return base / name.replace("\\", "/")


def _requests(rows, style_encoding_type):
    """CSV rows -> `Request`s, as zeggs_tpu's CLI builds them."""
    reqs = []
    for row in rows:
        if str(row.get("generate", "TRUE")).upper() not in ("TRUE", "1", "YES"):
            continue
        rb = Path(row["base_path"].replace("\\", "/"))
        frames = (
            tuple(int(x) for x in str(row["frames"]).split(" "))
            if row.get("frames") and str(row["frames"]).strip()
            else None
        )
        styles = (
            [(_rel(rb, row["style"]), frames)]
            if style_encoding_type == "example"
            else [row["style"]]
        )
        reqs.append(Request(
            audio=_rel(rb, row["audio"]),
            styles=styles,
            file_name=row.get("file_name") or Path(row["audio"]).stem,
            temperature=float(row.get("temperature", 1.0)),
            seed=int(row.get("seed", 1234)),
            first_pose=_rel(rb, row["first_pose"]) if row.get("first_pose") else None,
        ))
    return reqs


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    with open(args.options) as f:
        options_dict = json.load(f)
    opts = Options.from_options_dict(options_dict)

    paths = options_dict["paths"]
    data_path = Path(paths["base_path"]) / paths["path_processed_data"]
    network_path = Path(paths["models_dir"])
    output_path = Path(paths["output_dir"]) if paths.get("output_dir") else network_path.parent
    results_path = Path(args.results_path) if args.results_path else output_path / "results"

    pipeline = GesturePipeline(network_path, data_path, options=opts,
                               style_encoding_type=args.style_encoding_type, device=args.device,
                               rollout_weights="int8" if args.int8 else None)
    common = dict(network_path=network_path, data_path=data_path, results_path=results_path,
                  style_encoding_type=args.style_encoding_type, pipeline=pipeline)

    if args.csv is not None:
        with open(args.csv, newline="") as f:
            rows = list(csv.DictReader(f))
        if args.batch:
            written = generate_batch(pipeline, _requests(rows, args.style_encoding_type),
                                     results_path)
            print(f"batched mode: wrote {len(written)} clips")
            print(f"results written to {results_path}")
            return
        for i, row in enumerate(rows):
            if str(row.get("generate", "TRUE")).upper() not in ("TRUE", "1", "YES"):
                continue
            rb = Path(row["base_path"].replace("\\", "/"))
            frames = (
                [int(x) for x in str(row["frames"]).split(" ")]
                if row.get("frames") and str(row["frames"]).strip()
                else None
            )
            style = (
                [(_rel(rb, row["style"]), frames)]
                if args.style_encoding_type == "example"
                else [row["style"]]
            )
            print(f"[{i + 1}/{len(rows)}] {row.get('file_name')}")
            generate_gesture(
                audio_file=_rel(rb, row["audio"]),
                styles=style,
                file_name=row.get("file_name") or None,
                first_pose=_rel(rb, row["first_pose"]) if row.get("first_pose") else None,
                temperature=float(row.get("temperature", 1.0)),
                seed=int(row.get("seed", 1234)),
                **common,
            )
    else:
        if args.audio is None or args.style is None:
            parser.error("single-pair mode requires -a/--audio and -s/--style (or use -c CSV mode)")
        style = (
            [(Path(args.style), tuple(args.frames) if args.frames else None)]
            if args.style_encoding_type == "example"
            else [args.style]
        )
        generate_gesture(
            audio_file=Path(args.audio),
            styles=style,
            file_name=args.file_name,
            first_pose=Path(args.first_pose) if args.first_pose else None,
            temperature=args.temperature,
            seed=args.seed,
            **common,
        )
    print(f"results written to {results_path}")


if __name__ == "__main__":
    main()
