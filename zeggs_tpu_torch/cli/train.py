"""Training CLI (counterpart of `zeggs_tpu/cli/train.py`): ``-o options.json
-n name`` resolves the output, saved_models and logs directories, writes the
merged options.json with a provenance stamp, then runs the trainer.

Several processes, one a card, train as one over a shared filesystem
(`train.loop.Trainer`): start every process with the same options, either
under torchrun or with the three flags. Only rank 0 writes options.json,
the metrics, checkpoints and samples.

Usage:
  python -m zeggs_tpu_torch.cli.train -o configs/configs_v1.json -n my_run
  python -m zeggs_tpu_torch.cli.train -o options.json --max-iterations 100 --device cpu
  torchrun --nproc-per-node 4 -m zeggs_tpu_torch.cli.train -o options.json -n my_run
  python -m zeggs_tpu_torch.cli.train -o options.json -n my_run \
      --coordinator-address host0:29500 --num-processes 8 --process-id <rank>
"""

from __future__ import annotations

import argparse
import datetime
import json
import platform
import subprocess
from pathlib import Path

import torch

from ..config import Options, resolve_output_dirs
from ..parallel import distributed
from ..train.loop import Trainer
from ..utils import flatten_dict
from ..utils.metrics import make_writer


def _provenance(device):
    """Git hash and versions, for reproducing a run."""
    from .. import __version__

    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                             cwd=Path(__file__).resolve().parents[2], timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        rev = None
    dev = torch.device(device)
    return {
        "zeggs_tpu_torch": __version__,
        "git": rev or None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": platform.python_version(),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="zeggs_tpu_torch.train", description="Train ZEGGS networks")
    p.add_argument("-o", "--options", type=str, required=True)
    p.add_argument("-n", "--name", type=str, required=False)
    p.add_argument("--max-iterations", type=int, default=None, help="override 1000*niterations")
    p.add_argument("--host-batches", action="store_true",
                   help="assemble batches on the host instead of the device-resident corpus "
                   "(for corpora larger than the card's memory)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default: this process's card) or cpu")
    # several processes: every one runs this CLI with the same options
    p.add_argument("--coordinator-address", type=str, default=None,
                   help="host:port of rank 0, e.g. host0:29500")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dist-backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="collectives backend: nccl on a card, gloo on the CPU by default "
                   "(gloo lets several processes share one card)")
    args = p.parse_args(argv)

    grouped = distributed.initialize(args.coordinator_address, args.num_processes,
                                     args.process_id, backend=args.dist_backend,
                                     device=args.device)
    try:
        return _train(args)
    finally:
        if grouped:
            torch.distributed.destroy_process_group()


def _train(args):
    rank = distributed.process_index()
    opts = Options.from_options_json(args.options)
    name = args.name
    if name is None and opts.paths.output_dir is None and distributed.process_count() > 1:
        # one timestamped directory for every process: rank 0's
        stamp = [datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")]
        torch.distributed.broadcast_object_list(stamp, src=0)
        name = stamp[0]
    output_dir, models_dir, logs_dir = resolve_output_dirs(opts, name)
    processed = Path(opts.paths.base_path) / opts.paths.path_processed_data

    trainer = Trainer(
        opts, models_dir, logs_dir, processed / "processed_data.npz",
        processed / "data_definition.json", device_corpus=not args.host_batches,
        device=args.device,
    )
    writer = None
    if rank == 0:
        merged = opts.to_options_dict()
        merged["paths"]["output_dir"] = str(output_dir)
        merged["paths"]["models_dir"] = str(models_dir)
        merged["provenance"] = _provenance(trainer.device)
        (output_dir / "options.json").write_text(json.dumps(merged, indent=4))
        trainer.writer = writer = make_writer(logs_dir, opts.train.use_tensorboard)
        writer.write_hparams(flatten_dict(merged["net_opt"]) | flatten_dict(merged["train_opt"]))

    def on_step(it, metrics):
        if it % 10 == 0 and rank == 0:
            print(f"iter {it}: loss={float(metrics['total_loss']):.4f}", flush=True)

    try:
        trainer.run(max_iterations=args.max_iterations, on_step=on_step)
        trainer.save_checkpoint()
    finally:
        if writer is not None:
            writer.close()
    print("Done!")
    return trainer


if __name__ == "__main__":
    main()
