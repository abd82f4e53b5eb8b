"""``rollout_mfu.offline``: the generated frames' share of the card's
float32 peak: the speech encoder's and a decoder step's products for each
real frame written (padding rows and frames do not count), over the
window's wall time."""

from benchmark import flops


def read(run, trace):
    return 100.0 * run.rollout_flops() / run.window_s / flops.PEAK_OPS["float32"]
