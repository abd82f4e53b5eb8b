"""``featurize_ms_per_clip.offline``: the featurization of one request in
the traced job: the union of the job's ``zeggs:batch.prepare#<request>``
spans (WAV, loudness, mel, first-pose FK, style) over the number of
requests they name. Nothing is read where the program has no such span."""

import numpy as np

from benchmark.trace import length_s, union

PREFIX = "zeggs:batch.prepare#"


def read(run, trace):
    spans = [(n, s, e) for n, s, e in trace.host if n.startswith(PREFIX)]
    if not spans:
        return None
    iv = union(np.array([(s, e) for _, s, e in spans], np.int64))
    return 1e3 * length_s(iv) / len({n for n, _, _ in spans})
