"""The port's quickstart: corpus -> pipeline -> train -> generate -> serve,
in miniature (counterpart of `examples/quickstart.py`).

Builds a tiny synthetic mocap and speech corpus (3 clips of 4 s), prepares
it with the corpus pipeline, trains narrow networks (`data/synthetic.py::
small_options`, batch 4) for 30 iterations, synthesizes a gesture clip for
clip 1's speech in clip 0's style, and serves the same model over HTTP for
one /synthesize: the whole workflow through the port's own entry points.

    python -m zeggs_tpu_torch.examples.quickstart [workdir] [--device cpu]

Everything goes under ``workdir`` (by default ``zeggs_torch_quickstart`` in
the temporary directory). The default device is the card; ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
import urllib.request
from pathlib import Path

from ..cli.generate import main as generate_main
from ..cli.pipeline import main as pipeline_main
from ..cli.train import main as train_main
from ..config import Options
from ..data.synthetic import small_options, write_raw_corpus
from ..device import require_device
from ..infer import GesturePipeline
from ..io import bvh
from ..serve import GestureServer

ITERATIONS = 30


def main(argv=None):
    ap = argparse.ArgumentParser(prog="zeggs_tpu_torch.examples.quickstart",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?",
                    default=str(Path(tempfile.gettempdir()) / "zeggs_torch_quickstart"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = str(require_device(args.device))
    root = Path(args.workdir)
    root.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    print("== 1. synthesize a raw corpus (3 clips of mocap + speech)")
    write_raw_corpus(root, n_clips=3, seconds=4.0)
    (root / "pipeline_conf.json").write_text(json.dumps({
        "base_path": str(root),
        "processed_data_path": "processed",
        "info_filename": "info.csv",
        "audio_conf": {"normalize_loudness": False},
        "len_ratios": [1.0],
        "save_trimmed_audio": False,
        "save_trimmed_animation": False,
    }))

    print("== 2. run the data pipeline")
    pipeline_main(["-c", str(root / "pipeline_conf.json"), "--workers", "1",
                   "--device", device])

    print(f"== 3. train for {ITERATIONS} iterations")
    opts = small_options().to_options_dict()
    opts["paths"] = {"base_path": str(root), "path_processed_data": "processed",
                     "output_dir": None, "models_dir": None}
    opts["train_opt"].update(batchsize=4, generate_samples_step=1000, use_tensorboard=False)
    (root / "options.json").write_text(json.dumps(opts, indent=2))
    train_main(["-o", str(root / "options.json"), "-n", "quickstart", "--max-iterations",
                str(ITERATIONS), "--device", device])

    print("== 4. generate a gesture for clip 1's speech in clip 0's style")
    run_options = root / "outputs" / "quickstart" / "options.json"
    generate_main(["-o", str(run_options),
                   "-s", str(root / "original" / "000_Synth_0.bvh"),
                   "-a", str(root / "original" / "001_Synth_1.wav"),
                   "-n", "quickstart_demo", "-r", "42", "--device", device])
    out = root / "outputs" / "quickstart" / "results" / "quickstart_demo.bvh"
    anim = bvh.load(out)
    frames = anim["rotations"].shape[0]
    print(f"== generated: {out} ({frames} frames, {len(anim['names'])} joints)")

    print("== 5. serve the same model over HTTP (dynamic micro-batching)")
    run_opts = json.loads(run_options.read_text())
    pipe = GesturePipeline(Path(run_opts["paths"]["models_dir"]), root / "processed",
                           options=Options.from_options_dict(run_opts), device=device)
    server = GestureServer(pipe, max_wait_ms=20)
    port = server.start()
    body = json.dumps({
        "audio_path": str(root / "original" / "001_Synth_1.wav"),
        "style_path": str(root / "original" / "000_Synth_0.bvh"),
        "seed": 42,
    }).encode()
    try:
        with urllib.request.urlopen(
                urllib.request.Request(f"http://127.0.0.1:{port}/synthesize", data=body),
                timeout=600) as r:
            resp = json.loads(r.read())
    finally:
        server.stop()
    n_lines = resp["bvh"].count("\n")
    wall_s = time.perf_counter() - t_start
    print(f"== done: HTTP response carried {n_lines}-line BVH "
          f"(batch_size={resp['batch_size']}, {resp['latency_ms']:.0f} ms); "
          f"{wall_s:.1f} s in all")
    return {"bvh": str(out), "frames": frames, "http_bvh_lines": n_lines,
            "http_batch_size": resp["batch_size"], "http_latency_ms": resp["latency_ms"],
            "wall_s": wall_s, "response": resp}


if __name__ == "__main__":
    main()
