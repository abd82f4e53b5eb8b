"""Training metric sinks (counterpart of `zeggs_tpu/utils/metrics.py`):
TensorBoard where it is installed, else one JSON line a logged step."""

from __future__ import annotations

import json
import time
from pathlib import Path


class JsonlWriter:
    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def write(self, step, metrics):
        rec = {"step": int(step), "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def write_hparams(self, hparams):
        (self.path.parent / "hparams.json").write_text(json.dumps(hparams, indent=2, default=str))

    def close(self):
        self._f.close()


class TensorBoardWriter:
    def __init__(self, logdir, flush_secs=10):
        from torch.utils.tensorboard import SummaryWriter

        self._w = SummaryWriter(str(logdir), flush_secs=flush_secs)

    def write(self, step, metrics):
        total = metrics.get("total_loss")
        if total is not None:
            self._w.add_scalar("losses/total_loss", float(total), step)
        self._w.add_scalars(
            "losses/losses", {k: float(v) for k, v in metrics.items() if k != "total_loss"}, step
        )

    def write_hparams(self, hparams):
        self._w.add_hparams({k: str(v) for k, v in hparams.items()}, {"No Metric": 0.0})

    def close(self):
        self._w.close()


def make_writer(logdir, use_tensorboard=True):
    """TensorBoard under logdir/tb when asked for and importable, else
    JSON lines in logdir/metrics.jsonl."""
    if use_tensorboard:
        try:
            return TensorBoardWriter(Path(logdir) / "tb")
        except Exception:
            pass
    return JsonlWriter(Path(logdir) / "metrics.jsonl")
