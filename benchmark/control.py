"""The control runs of a cell, which the benchmark's own runs do not make:

    python -m benchmark.control --workload v1.train --seeds 11,12,13 --seconds 5

For each seed: a whole run (set-up, a short window at the cell's load, the
program's state freed), then the numbers compared three ways: the program
against the reference (a sound run), the control (the reference computed
in TF32, the step below the configuration's float32, in the program's
place) against the reference, and, where the cell has them, the faults
planted in the reference. One JSON line a seed; the limits in the mix lie
between the sound runs' largest readings and the smallest of these.
"""

from __future__ import annotations

import argparse
import json
import sys

from .common import Cell, Clock, set_cache_dirs
from .run import generator_of


def main(argv=None):
    set_cache_dirs()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("benchmark.control: the control runs the reference in TF32 on a card",
              file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        clock = Clock()
        run = generator_of(cell).Run(cell, cell.config, seed, "cuda")
        run.setup()
        setup_s = clock()
        run.window(args.seconds)
        run.release()
        try:
            sound = {k: v["value"] for k, v in run.check().items()}
            control = run.control()
            faults = run.faults() if hasattr(run, "faults") else {}
        finally:
            run.close()
        print(json.dumps({"workload": cell.name, "seed": seed, "setup_s": setup_s,
                          "sound": sound, "control": control, "faults": faults}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
