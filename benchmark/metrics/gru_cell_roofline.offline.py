"""``gru_cell_roofline.offline``: the GRU-cell kernel's share of its
roofline over the traced job: the sum of each call's bound
(`flops.gru_cell_bound_s` at its chunk's batch) over the kernel's device
time in the trace. Nothing is read when the trace holds another number of
calls than the job's chunks run."""

KERNEL = "gru_cell_kernel"


def read(run, trace):
    calls, seconds = trace.kernels(KERNEL)
    expected = sum(n for _, n in run.gru_calls())
    if calls == 0 or calls != expected:
        return None
    return 100.0 * run.gru_bound_s() / seconds
