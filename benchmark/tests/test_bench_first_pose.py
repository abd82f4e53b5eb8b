"""The reader of the batched first-pose pass (`first_pose_ms_per_clip.offline`):
on hand-made traces (overlapping passes count once, the time is shared over
the clips the passes name, and nothing is read where the program has no such
pass), and in the CPU rehearsal of the offline cell."""

import pytest

from benchmark.run import read_metric
from benchmark.tests.test_bench_cells import rehearse
from benchmark.trace import Trace

MS = 1_000_000  # ns
NAME = "first_pose_ms_per_clip.offline"


def _trace(*spans):
    return Trace(1.0, host=[(n, s * MS, e * MS) for n, s, e in spans])


def test_first_pose_takes_the_union_over_the_clips_of_its_passes():
    tr = _trace(("zeggs:batch.first_poses#16", 0, 30), ("zeggs:batch.first_poses#4", 25, 40),
                ("zeggs:batch.first_poses#16", 0, 30),  # a copy of the first pass: counted once
                ("zeggs:batch.first_pose", 50, 60), ("zeggs:batch.featurize", 0, 45))
    assert read_metric(NAME, None, tr) == pytest.approx(2.0)


@pytest.mark.parametrize("spans", [
    [("bench:generate_batch", 0, 50), ("aten::mm", 1, 2)],
    # a program that featurizes each first pose inside its request's span
    [("bench:generate_batch", 0, 50), ("zeggs:batch.first_pose", 3, 4)],
])
def test_first_pose_reads_nothing_without_its_passes(spans):
    assert read_metric(NAME, None, _trace(*spans)) is None


def test_offline_rehearsal_reports_the_first_pose_pass():
    _, res = rehearse("v2.offline", trace=1)
    assert res["metrics"][NAME]["value"] > 0
