"""``rollout_mfu.film_offline``: the generated frames' share of the card's
float32 peak: the speech encoder's and a FiLM decoder step's products
(`flops_film.rollout_flops_per_frame`) for each real frame written
(padding rows and frames do not count), over the window's wall time."""

from benchmark import flops


def read(run, trace):
    return 100.0 * run.rollout_flops() / run.window_s / flops.PEAK_OPS["float32"]
