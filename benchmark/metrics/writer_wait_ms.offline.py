"""``writer_wait_ms.offline``: the time the traced job's main thread spent
blocked on its outputs: the union of its ``zeggs:batch.collect`` spans
(each chunk's wait on the copies to the host) and its
``zeggs:batch.wait_writes`` span (the wait on the BVH writers), in ms.
Nothing is read where the program has no such span."""

import numpy as np

from benchmark.trace import length_s, union

NAMES = ("zeggs:batch.collect", "zeggs:batch.wait_writes")


def read(run, trace):
    iv = [(s, e) for n, s, e in trace.host if n in NAMES]
    if not iv:
        return None
    return 1e3 * length_s(union(np.array(iv, np.int64)))
