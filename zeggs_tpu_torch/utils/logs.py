"""Console progress line and plain-text tables (counterpart of the parts of
`zeggs_tpu/utils/logs.py` that training and the corpus pipeline use)."""

from __future__ import annotations

import datetime


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
