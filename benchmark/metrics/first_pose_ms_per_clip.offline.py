"""``first_pose_ms_per_clip.offline``: the first-pose featurization of one
request in the traced job: the union of the job's
``zeggs:batch.first_poses#<n>`` spans (each one pass over n first poses:
FK, velocities, gaze) over the sum of their n. Nothing is read where the
program has no such span."""

import numpy as np

from benchmark.trace import length_s, union

PREFIX = "zeggs:batch.first_poses#"


def read(run, trace):
    spans = {(n, s, e) for n, s, e in trace.host if n.startswith(PREFIX)}
    if not spans:
        return None
    iv = union(np.array([(s, e) for _, s, e in spans], np.int64))
    return 1e3 * length_s(iv) / sum(int(n[len(PREFIX):]) for n, _, _ in spans)
