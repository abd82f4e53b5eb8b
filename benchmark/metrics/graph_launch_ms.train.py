"""``graph_launch_ms.train``: the host's time to launch one replay of the
train step's graphs: the program's counter ``train.replay_s`` (from just
before the first graph's ``replay()`` to the return of the last one's) over
``train.replays``, totals of the process, so the untraced window's replays
outweigh the traced ones. Nothing is read where the program has no
counters or ran no replay (the CPU)."""


def read(run, trace):
    try:
        from zeggs_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    replays = c.get("train.replays", 0)
    return 1e3 * c.get("train.replay_s", 0.0) / replays if replays else None
