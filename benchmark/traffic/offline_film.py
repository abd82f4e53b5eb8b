"""Offline traffic over a FiLM decoder: `offline_jobs`'s jobs of speech clips
written to BVH by `generate_batch`, with label styles and a first pose per
clip, for a configuration whose decoder cell is ``film``.

Only what depends on the networks differs from `offline_jobs.Run`: the
parameter draw and the pipeline's files are made over the FiLM networks,
the check and the control run `reference/decoder_film.py`, and the
operations a frame needs are the FiLM step's (`flops_film`). While set-up,
the check or the control runs, `inputs` and `infer_check` see
`reference.decoder_film` where they see `reference.model` (`film_reference`):
it has the same functions, with the FiLM decoder.

The window also reads the program's counters ``programs.rollout_steps`` and
``programs.rollout_device_s`` before and after its jobs (`window_counts`),
for ``decoder_step_us`` and ``decoder_step_roofline``; a program without
them reads 0 for both. They are read over the untraced window, not over
the traced job: under the profiler a graph's launch holds the host for as
long as its kernels take to be recorded, and the card waits on it inside
the timed interval.
"""

from __future__ import annotations

import contextlib

from benchmark import flops_film, infer_check, inputs
from benchmark.reference import decoder_film
from benchmark.traffic import offline_jobs

#: the program's counters read around the traced job
COUNTERS = ("programs.rollout_steps", "programs.rollout_device_s")


@contextlib.contextmanager
def film_reference():
    """`inputs` and `infer_check` with `reference.decoder_film` in the place
    of `reference.model`."""
    saved = inputs.model, infer_check.model
    inputs.model = infer_check.model = decoder_film
    try:
        yield
    finally:
        inputs.model, infer_check.model = saved


class Run(offline_jobs.Run):
    def setup(self):
        with film_reference():
            super().setup()

    def window(self, seconds):
        from zeggs_tpu_torch.utils.profiling import counters

        before = counters()
        out = super().window(seconds)
        after = counters()
        self.window_counts = {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS}
        return out

    def decoder_steps(self):
        """(B, steps) of one job's chunks: T_pad - 1 decoder steps a chunk,
        of one row too (the FiLM cell has no B=1 kernel)."""
        return [(B, T - 1) for T, B in self.shapes]

    def window_steps(self):
        """The decoder steps the window's jobs run."""
        return len(self.jobs) * sum(n for _, n in self.decoder_steps())

    def window_bound_s(self):
        """The least device time of the window's replayed steps
        (`flops_film.step_bound_s` at each chunk's B)."""
        job = sum(n * flops_film.step_bound_s(self.cfg, B) for B, n in self.decoder_steps())
        return len(self.jobs) * job

    def rollout_flops(self):
        return self.window_frames * flops_film.rollout_flops_per_frame(self.cfg)

    def check(self, tf32=False):
        with film_reference():
            return super().check(tf32)

    def control(self):
        with film_reference():
            return super().control()
