"""The readers of the program's spans and counters (`benchmark/metrics/`):
on hand-made traces and counter snapshots (overlapping spans count once,
spans group by their request id, and nothing is read where the program
has no span or counter), and in the CPU rehearsal of the offline cell,
where the frame yield equals what the tiny mix gives."""

import sys
import types

import pytest

from benchmark.run import read_metric
from benchmark.tests.test_bench_cells import rehearse
from benchmark.tests.tiny import tiny_config
from benchmark.trace import Trace
from benchmark.traffic.offline_jobs import chunk_shapes
from benchmark import inputs

MS = 1_000_000  # ns


def _trace(*spans):
    return Trace(1.0, host=[(n, s * MS, e * MS) for n, s, e in spans])


def test_featurize_takes_the_union_over_the_requests():
    tr = _trace(("zeggs:batch.prepare#a", 0, 10), ("zeggs:batch.prepare#b", 10, 30),
                ("zeggs:batch.prepare#a", 2, 5),  # a copy of a's span: counted once
                ("zeggs:batch.audio", 0, 40), ("bench:generate_batch", 0, 50))
    assert read_metric("featurize_ms_per_clip.offline", None, tr) == pytest.approx(15.0)


def test_writer_wait_takes_the_union_of_collects_and_the_final_wait():
    tr = _trace(("zeggs:batch.collect", 0, 5), ("zeggs:batch.wait_writes", 4, 10),
                ("zeggs:batch.collect", 20, 22), ("zeggs:batch.dispatch", 10, 20))
    assert read_metric("writer_wait_ms.offline", None, tr) == pytest.approx(12.0)


@pytest.mark.parametrize("name", ["featurize_ms_per_clip.offline", "writer_wait_ms.offline"])
def test_span_readers_read_nothing_without_spans(name):
    tr = _trace(("bench:generate_batch", 0, 50), ("aten::mm", 1, 2))
    assert read_metric(name, None, tr) is None


def _counters(monkeypatch, values):
    from zeggs_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: dict(values))


@pytest.mark.parametrize("name,values,expected", [
    ("rollout_frame_yield.offline", {"batch.frames": 9600, "batch.frames_rolled": 24576},
     100 * 9600 / 24576),
    ("rollout_frame_yield.offline", {"batch.frames": 5}, None),
    ("graph_launch_ms.train", {"train.replays": 4, "train.replay_s": 1.2}, 300.0),
    ("graph_launch_ms.train", {"programs.captures": 1}, None),
])
def test_counter_readers(monkeypatch, name, values, expected):
    _counters(monkeypatch, values)
    value = read_metric(name, None, _trace())
    assert value == (None if expected is None else pytest.approx(expected))


@pytest.mark.parametrize("name", ["rollout_frame_yield.offline", "graph_launch_ms.train"])
def test_counter_readers_read_nothing_from_a_program_without_counters(monkeypatch, name):
    # a program of before the counters: its profiling module has none
    monkeypatch.setitem(sys.modules, "zeggs_tpu_torch.utils.profiling",
                        types.ModuleType("zeggs_tpu_torch.utils.profiling"))
    assert read_metric(name, None, _trace()) is None


def test_offline_rehearsal_reports_the_program_metrics():
    from zeggs_tpu_torch.utils import profiling

    before = profiling.counters()
    cell, res = rehearse("v2.offline", trace=1)
    after = profiling.counters()
    metrics = res["metrics"]
    for name in ("featurize_ms_per_clip.offline", "writer_wait_ms.offline"):
        assert metrics[name]["value"] > 0, name
    mix = cell.mix
    fs = tiny_config(cell.workload["config"])["audio_conf"]["sampling_rate"]
    frames = [int(round(60.0 * int(round(s * fs)) / fs))
              for s in inputs.uniform_lengths(mix["lines"], mix["min_s"], mix["max_s"])]
    jobs = res["attempted"] // mix["lines"] + 1  # the window's and the traced one
    longest = max(frames)
    single = max(mix["bucket"], -(-longest // mix["bucket"]) * mix["bucket"])  # set-up's line
    real = jobs * sum(frames) + longest
    rolled = jobs * sum(T * B for T, B in chunk_shapes(frames, mix["bucket"], mix["max_batch"]))
    rolled += single
    assert after["batch.frames"] - before.get("batch.frames", 0) == real
    assert after["batch.frames_rolled"] - before.get("batch.frames_rolled", 0) == rolled
    assert metrics["rollout_frame_yield.offline"]["value"] == pytest.approx(
        100.0 * after["batch.frames"] / after["batch.frames_rolled"])


def test_train_rehearsal_reads_no_launch_time_on_the_cpu():
    _, res = rehearse("v1.train", trace=1)
    assert "graph_launch_ms.train" not in res["metrics"]
