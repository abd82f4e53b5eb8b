"""``train_mfu``: the train step's share of the card's float32 peak, from
the benchmark's analytic operations of a step (`flops.train_step_flops`:
forward and backward products at the configuration's widths) over the
window's step time."""

from benchmark import flops


def read(run, trace):
    return 100.0 * run.flops_per_step() / run.step_s / flops.PEAK_OPS["float32"]
