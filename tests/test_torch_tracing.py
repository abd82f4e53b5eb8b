"""The port's spans and counters (`zeggs_tpu_torch/utils/profiling.py`) on
the CPU, and the train program's replay counters on a card (``-m cuda``).

* `generate_batch` at a narrow width (8 joints, tests/synthetic.py) under
  `torch.profiler`: every span of the batch orchestration and of the
  rollout and finish programs, nested in ``zeggs:batch``; one
  ``zeggs:batch.prepare#<file_name>`` a request, and the first poses
  featurized after them in one pass; the counters' deltas as
  `plan_programs` and the clip lengths give them.
* Under `profiling.trace`, the BVH writer threads' spans reach
  ``trace.json`` where the installed torch traces every thread.
* With no profiler, `annotate` is one shared null context and leaves
  nothing for a later profile.
* `TrainProgram.run` on the CPU opens the staging and eager spans and
  replays nothing; on a card its replays count and time themselves.
"""

import json
import sys
import threading
import types

import numpy as np
import pytest
import torch

from zeggs_tpu_torch.infer import GesturePipeline
from zeggs_tpu_torch.infer.batch import Request, generate_batch, plan_programs
from zeggs_tpu_torch.io import bvh
from zeggs_tpu_torch.utils import profiling

BUCKET, MAX_BATCH, NFRAMES = 64, 2, 150
BATCH_SPANS = ["zeggs:batch", "zeggs:batch.featurize", "zeggs:batch.audio",
               "zeggs:batch.style_example", "zeggs:batch.first_pose", "zeggs:batch.first_poses#1",
               "zeggs:batch.encode_styles", "zeggs:batch.assemble", "zeggs:batch.dispatch",
               "zeggs:batch.collect", "zeggs:batch.wait_writes", "zeggs:program.rollout",
               "zeggs:program.finish"]
# name -> (audio clip, style clips, first pose clip)
REQUESTS = {"one": (0, [1], None), "two": (1, [0, 2], None), "posed": (2, [0, 1], 0)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from tests.synthetic import small_options, write_corpus

    from zeggs_tpu_torch import config as TC

    root = tmp_path_factory.mktemp("tracing_corpus")
    data_dir, net_dir, clips, opts = write_corpus(root, n_clips=3, nframes=NFRAMES)
    topts = TC.Options.from_options_dict(small_options().to_options_dict())
    return dict(data=data_dir, nets=net_dir, clips=clips, topts=topts)


def _pipe(c):
    return GesturePipeline(c["nets"], c["data"], options=c["topts"], device="cpu")


def _requests(c):
    return [Request(audio=c["clips"][a][1], styles=[(c["clips"][s][0], None) for s in styles],
                    file_name=name, seed=3 + i,
                    first_pose=None if first is None else c["clips"][first][0])
            for i, (name, (a, styles, first)) in enumerate(REQUESTS.items())]


def _events(prof):
    """(name, start ns, end ns, thread) of the profile's host events."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
            for e in prof.profiler.kineto_results.events()]


def _delta(before):
    after = profiling.counters()
    return {k: after.get(k, 0) - before.get(k, 0) for k in set(after) | set(before)}


def test_generate_batch_spans_nest_and_counters_add_up(corpus, tmp_path):
    pipe, reqs = _pipe(corpus), _requests(corpus)
    before = profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        written = generate_batch(pipe, reqs, tmp_path, bucket=BUCKET, max_batch=MAX_BATCH)
    spans = [e for e in _events(prof) if e[0].startswith("zeggs:")]
    names = [e[0] for e in spans]
    for name in BATCH_SPANS:
        assert name in names, name
    (_, b0, b1, _), = [e for e in spans if e[0] == "zeggs:batch"]
    assert all(b0 <= s and e <= b1 for _, s, e, _ in spans)
    prepares = sorted(n for n in names if n.startswith("zeggs:batch.prepare#"))
    assert prepares == sorted(f"zeggs:batch.prepare#{r.file_name}" for r in reqs)
    # the writer threads' spans are not made under a profiler of this thread
    assert not any(n.startswith("zeggs:batch.write") for n in names)

    lengths = [bvh.load(p)["rotations"].shape[0] for p in written]
    plan = plan_programs(lengths, bucket=BUCKET, max_batch=MAX_BATCH)
    assert len(plan) == 2  # distinct shapes: one entry a chunk
    for stage in ("assemble", "dispatch", "collect"):
        assert names.count(f"zeggs:batch.{stage}") == len(plan)
    # the posed request's BVH is parsed inside its prepare span; its FK runs
    # in the job's one pass over first poses, after every request's span
    assert names.count("zeggs:batch.first_pose") == 1
    assert [n for n in names if n.startswith("zeggs:batch.first_poses")] == [
        "zeggs:batch.first_poses#1"]
    (_, p0, p1, _), = [e for e in spans if e[0] == "zeggs:batch.first_pose"]
    (_, q0, q1, _), = [e for e in spans if e[0] == "zeggs:batch.first_poses#1"]
    (_, r0, r1, _), = [e for e in spans if e[0] == "zeggs:batch.prepare#posed"]
    assert r0 <= p0 and p1 <= r1
    assert all(e <= q0 for n, _, e, _ in spans if n.startswith("zeggs:batch.prepare#"))
    crosses = [s for n, s, _, _ in _events(prof) if n == "aten::linalg_cross"]
    assert not any(p0 <= s <= p1 for s in crosses)
    assert any(q0 <= s <= q1 for s in crosses)
    assert names.count("zeggs:batch.style_example") == 5
    delta = _delta(before)
    assert delta["batch.clips"] == len(reqs)
    assert delta["batch.frames"] == sum(lengths) == len(reqs) * NFRAMES
    assert delta["batch.frames_rolled"] == sum(T * B for T, B in plan)
    assert delta["batch.first_poses"] == sum(r.first_pose is not None for r in reqs) == 1
    assert delta["batch.first_pose_passes"] == 1
    # five BVH styles over three clips: each clip featurized once
    assert (delta["style_cache.misses"], delta["style_cache.hits"]) == (3, 2)
    assert delta.get("programs.captures", 0) == 0  # the CPU captures nothing


def test_writer_thread_spans_reach_the_exported_trace(corpus, tmp_path):
    pipe, reqs = _pipe(corpus), _requests(corpus)
    with profiling.trace(tmp_path / "trace"):
        generate_batch(pipe, reqs, tmp_path / "out", bucket=BUCKET, max_batch=MAX_BATCH)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    main = {e["tid"] for e in events if e.get("name") == "zeggs:batch"}
    writes = [e for e in events if str(e.get("name", "")).startswith("zeggs:batch.write#")]
    if profiling._all_threads() is None:  # this torch traces the calling thread only
        assert writes == []
    else:
        assert sorted(e["name"] for e in writes) == sorted(
            f"zeggs:batch.write#{r.file_name}" for r in reqs)
        assert not {e["tid"] for e in writes} & main
    assert profiling._tracing == 0


def test_annotate_without_a_profiler_makes_nothing():
    off = profiling.annotate("zeggs:test.off")
    assert off is profiling.annotate("zeggs:test.off", rid="r1")
    assert not isinstance(off, torch.profiler.record_function)
    with off, profiling.annotate("zeggs:test.nested"):
        torch.ones(4) + 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(4) * 2
    assert not any(n.startswith("zeggs:") for n, *_ in _events(prof))


def test_trace_turns_spans_on_in_every_thread(tmp_path):
    made = []

    def worker():
        made.append(isinstance(profiling.annotate("zeggs:test.worker"),
                               torch.profiler.record_function))

    with profiling.trace(tmp_path):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive() and made == [True]
    worker()
    assert made == [True, False]


def test_counters_add_from_many_threads():
    """More threads than cores, switching often: no addition is lost."""
    before = profiling.counters()

    def add():
        for _ in range(500):
            profiling.count("test.adds")
            profiling.count("test.seconds", 0.5)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=add) for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    delta = _delta(before)
    assert delta["test.adds"] == 16000 and delta["test.seconds"] == 8000.0


def test_counts_while_a_stream_captures_wait_for_the_replays(monkeypatch):
    """While the current stream captures, `count` adds to that stream's
    tally and not to the totals; the difference of two readings around the
    capture is what each replay adds, and another stream's tally is apart."""
    side, other = (types.SimpleNamespace(cuda_stream=h) for h in (0x5EED01, 0x5EED02))
    before, tally = profiling.counters(), profiling.captured(side)
    monkeypatch.setattr(profiling, "_capturing_stream", lambda: side.cuda_stream)
    profiling.count("test.captured", 3)
    profiling.count("test.seconds", 0.25)
    monkeypatch.setattr(profiling, "_capturing_stream", lambda: None)
    counts = profiling.captured(side) - tally
    assert counts == {"test.captured": 3, "test.seconds": 0.25}
    assert _delta(before).get("test.captured", 0) == 0 and not profiling.captured(other)
    for _ in range(2):
        profiling.replayed(counts)
    delta = _delta(before)
    assert delta["test.captured"] == 6 and delta["test.seconds"] == 0.5
    snap = profiling.counters()
    snap["test.adds"] = -1  # a copy: the counters stay
    assert profiling.counters()["test.adds"] != -1


def _train_program(device):
    """A one-process `TrainProgram` at a small width (8 joints, H=32, B=3,
    24 frames) on host batches -> (program, one step's inputs)."""
    from zeggs_tpu_torch.config import Options
    from zeggs_tpu_torch.train import loop
    from zeggs_tpu_torch.train.programs import TrainProgram

    rng = np.random.default_rng(5)
    J, B, T, L = 8, 3, 24, 40
    parents = [-1, 0, 1, 2, 3, 4, 3, 3]
    pose_in, pose_out = 6 + 15 * J + 3, 6 + 15 * J
    opts = Options.from_options_dict({"net_opt": {
        "decoder": {"nhidden": 32},
        "speech_encoder": {"nhidden": 16, "speech_encoding_size": 16},
        "style_encoder": {"nhidden": 24, "style_encoding_size": 8}}})
    stats = dict(audio_input_mean=rng.normal(size=81) * 0.1, audio_input_std=np.float32(1.5),
                 anim_input_mean=rng.normal(size=pose_in) * 0.1,
                 anim_input_std=rng.uniform(0.5, 2.0, pose_in),
                 anim_output_mean=rng.normal(size=pose_out) * 0.1,
                 anim_output_std=rng.uniform(0.05, 0.5, pose_out))
    q = rng.normal(size=(B, T, 4))
    batch = dict(root_pos=rng.normal(size=(B, T, 3)) * 10,
                 root_rot=q / np.linalg.norm(q, axis=-1, keepdims=True),
                 root_vel=rng.normal(size=(B, T, 3)), root_vrt=rng.normal(size=(B, T, 3)),
                 lpos=rng.normal(size=(B, T, J, 3)), ltxy=rng.normal(size=(B, T, J, 2, 3)),
                 lvel=rng.normal(size=(B, T, J, 3)), lvrt=rng.normal(size=(B, T, J, 3)),
                 audio_features=rng.normal(size=(B, T, 81)),
                 gaze_pos=np.repeat(rng.normal(size=(B, 1, 3)) * 100, T, axis=1),
                 example=rng.normal(size=(B, L, pose_in)))
    inputs = {k: np.asarray(v, np.float32) for k, v in batch.items()}
    inputs["example_lengths"] = np.array([L, 33, 20], np.int64)
    dims = dict(num_audio_features=81, pose_input_size=pose_in, pose_output_size=pose_out)
    nets = loop.init_networks(opts, dims, 3, 5, device)
    program = TrainProgram(loop.make_loss_fn(opts, stats, parents, 1 / 60, deterministic=True),
                           nets, loop.make_optimizer(opts, nets))
    return program, inputs


def test_train_program_spans_on_the_cpu():
    program, inputs = _train_program("cpu")
    before = profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(2):
            program.run(inputs, i)
    names = [n for n, *_ in _events(prof) if n.startswith("zeggs:")]
    assert names.count("zeggs:train.stage") == names.count("zeggs:train.eager") == 2
    assert "zeggs:train.replay" not in names
    delta = _delta(before)
    assert delta.get("train.replays", 0) == 0 and delta.get("train.replay_s", 0) == 0


@pytest.mark.cuda
def test_train_replays_count_and_time_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    program, inputs = _train_program(torch.device("cuda"))
    program.run(inputs, 0)  # eager
    before = profiling.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(1, 4):  # a capture, then three replays
            program.run(inputs, i)
    torch.cuda.synchronize()
    names = [n for n, *_ in _events(prof) if n.startswith("zeggs:")]
    assert names.count("zeggs:train.replay") == 3 and names.count("zeggs:program.capture") == 1
    delta = _delta(before)
    assert delta["train.replays"] == 3 and delta["programs.captures"] == 1
    assert delta["train.replay_s"] > 0.0
