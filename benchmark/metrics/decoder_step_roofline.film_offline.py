"""``decoder_step_roofline.film_offline``: the FiLM decoder steps' share of
their roofline over the window's jobs: for each job, the sum over its
chunks of their T_pad - 1 steps times the bound of one step at the chunk's
B (`flops_film.step_bound_s`), over the counter
``programs.rollout_device_s`` read before and after the window. Nothing is
read where the program has no such counters, or the counter
``programs.rollout_steps`` counts another number of steps than the
window's jobs run."""


def read(run, trace):
    counts = getattr(run, "window_counts", {})
    steps, seconds = counts.get("programs.rollout_steps", 0), counts.get(
        "programs.rollout_device_s", 0.0)
    if not seconds or steps != run.window_steps():
        return None
    return 100.0 * run.window_bound_s() / seconds
