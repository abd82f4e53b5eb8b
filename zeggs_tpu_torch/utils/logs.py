"""Logger factory, a multiprocess-safe logger proxy, the console progress
line and plain-text tables (counterpart of `zeggs_tpu/utils/logs.py`),
standard library only."""

from __future__ import annotations

import datetime
import logging
import multiprocessing as mp
import sys
from pathlib import Path

_FMT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def get_logger(name="zeggs_tpu_torch", level=logging.INFO, log_file=None, console=True):
    """Console and/or file logger; repeated calls reuse its handlers."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    have = {type(h).__name__ for h in logger.handlers}
    if console and "StreamHandler" not in have:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
    if log_file is not None and "FileHandler" not in have:
        Path(log_file).parent.mkdir(parents=True, exist_ok=True)
        h = logging.FileHandler(log_file)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
    return logger


def get_logger_from_arg(logger=None):
    """None or a name -> that logger; a logger passes through."""
    if logger is None or isinstance(logger, str):
        return get_logger(logger or "zeggs_tpu_torch")
    return logger


class QueueLogger:
    """Logger proxy for worker processes: records go onto a queue, and the
    parent drains them into a real logger."""

    def __init__(self, queue=None):
        self.queue = queue if queue is not None else mp.Manager().Queue()

    def _put(self, level, msg):
        self.queue.put((level, str(msg)))

    def debug(self, msg):
        self._put("debug", msg)

    def info(self, msg):
        self._put("info", msg)

    def warning(self, msg):
        self._put("warning", msg)

    def error(self, msg):
        self._put("error", msg)

    def drain(self, target_logger=None):
        target = get_logger_from_arg(target_logger)
        while not self.queue.empty():
            level, msg = self.queue.get_nowait()
            getattr(target, level)(msg)


class ConsolePrintLogger:
    """A logger stand-in that prints."""

    def debug(self, msg):
        print(msg)

    def info(self, msg):
        print(msg)

    def warning(self, msg):
        print(f"WARNING: {msg}")

    def error(self, msg):
        print(f"ERROR: {msg}", file=sys.stderr)


def percent_bar(ratio=1.0, width=30, empty=" ", done="#", parts=" -=>"):
    """ASCII progress bar."""
    if ratio >= 1.0:
        return done * width
    filled = int((100 * ratio) // (100 / width))
    part_idx = int(len(parts) * (((100 * ratio) / (100 / width)) % 1.0))
    return done * filled + parts[part_idx] + empty * max(width - filled - 1, 0)


def progress(epoch, iteration, batch_index, train_err, iter_num, start_time):
    """One-line training progress with an ETA."""
    ratio = (float(batch_index) + 1) / iter_num
    now = datetime.datetime.now()
    eta = start_time + (1.0 / (ratio + 1e-10)) * (now - start_time)
    return "| %5i | %6i | [%s] %6.2f%% | % 8.4f | %s |" % (
        epoch, iteration, percent_bar(ratio), 100 * ratio, train_err, str(eta)[11:19],
    )


def ascii_table(headers, rows, title=None):
    """Plain-text table."""
    cols = [headers] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cols) for i in range(len(headers))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [title] if title else []
    out += [sep, "| " + " | ".join(h.ljust(w) for h, w in zip(headers, widths)) + " |", sep]
    for r in cols[1:]:
        out.append("| " + " | ".join(c.ljust(w) for c, w in zip(r, widths)) + " |")
    out.append(sep)
    return "\n".join(out)
