"""``rollout_frame_yield.offline``: the share of the rollout frames the card
computes that are a request's own: 100 x the program's counter
``batch.frames`` (each request's frames) over ``batch.frames_rolled`` (B_pad
x T_pad of every chunk), totals of the process: set-up's job, the window's
and the traced one. Nothing is read where the program has no counters."""


def read(run, trace):
    try:
        from zeggs_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    rolled = c.get("batch.frames_rolled", 0)
    return 100.0 * c.get("batch.frames", 0) / rolled if rolled else None
