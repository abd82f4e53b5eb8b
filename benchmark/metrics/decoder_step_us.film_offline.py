"""``decoder_step_us.film_offline``: the device time of one decoder step
over the window's jobs (untraced): the program's counter
``programs.rollout_device_s`` (each rollout chunk's device time, from
before its first replay to after its last) over ``programs.rollout_steps``
(the steps replayed), both read before and after the window, in
microseconds. Nothing is read where the program has no such counters or
the card timed nothing."""


def read(run, trace):
    counts = getattr(run, "window_counts", {})
    steps, seconds = counts.get("programs.rollout_steps", 0), counts.get(
        "programs.rollout_device_s", 0.0)
    if not steps or not seconds:
        return None
    return 1e6 * seconds / steps
