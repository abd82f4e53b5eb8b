"""``device_idle.<cell>``: the device's idle share over the traced stretch,
1 - (the union of the intervals in which an operation ran on the device) /
(the stretch's wall time less the time the device idled under the
profiler's own overhead records), in %."""


def read(run, trace):
    return trace.idle_share()
