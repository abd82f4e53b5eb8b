"""The port's benchmark programs (`zeggs_tpu_torch/bench/`) on the CPU.

The orchestrator's contract, with its stages stubbed (mirroring
tests/test_bench_orchestrator.py); the refusals without a card; every
stage run for real at ``--device cpu --tiny --quick`` through the
orchestrator, its JSON keys held to the JAX stage's (`BENCH_r05.json`'s
``parsed.extra`` and `bench.py`'s core stage) less XLA's keys and plus the
port's; the serve stage's watchdog; and the fixture's copies held to
`__graft_entry__` and to `scripts/bench_serve.py`'s request draw.
"""

import ast
import hashlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from zeggs_tpu_torch.bench import __main__ as orch
from zeggs_tpu_torch.bench import fixture as FX
from zeggs_tpu_torch.ops.kernels import build

REPO = Path(__file__).resolve().parents[1]
#: subprocesses: no card visible, few threads (the suite runs in parallel)
ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")

CORE = {"platform": "gpu", "best_fps": 1_000_000.0, "fps8": 600_000.0, "lat_ms": 11.0,
        "lat8_ms": 9.5, "lat_cold_ms": 11.2, "lat_cold_p99_ms": 12.0, "correct": True}
OPTIONAL = {"serve", "streaming", "train", "train_bf16"}


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]


def _stage_of(argv):
    return argv[1].rsplit(".", 1)[1] + ("_bf16" if "--bf16" in argv else "")


def _run(monkeypatch, fake, budget, *flags):
    monkeypatch.setattr(orch, "_run_stage", fake)
    monkeypatch.setenv("ZEGGS_BENCH_BUDGET_S", str(budget))
    return orch.main(["--device", "cpu", "--tiny", *flags])


# ---------------------------------------------------------------------------
# the orchestrator, stages stubbed
# ---------------------------------------------------------------------------

def test_headline_first_and_stages_skipped_over_budget(monkeypatch, capsys):
    """On a budget too small for any later stage the headline line still
    comes out whole, each stage is marked skipped, and the exit code is 0."""
    calls = []

    def fake(argv, timeout):
        calls.append(argv)
        return dict(CORE)

    assert _run(monkeypatch, fake, 5) == 0
    lines = _lines(capsys)
    assert [_stage_of(a) for a in calls] == ["core"]
    for artifact in (lines[0], lines[-1]):
        assert artifact["metric"] == "gesture_frames_per_sec_per_chip"
        assert artifact["value"] == CORE["best_fps"]
        assert artifact["vs_baseline"] == round(CORE["best_fps"] / 1200, 3)
        assert artifact["extra"]["b1_latency_10s_clip_ms"] == CORE["lat_ms"]
        assert artifact["extra"]["platform"] == "cpu" and artifact["extra"]["rehearsal"] is True
    skipped = {k for k, v in lines[-1]["extra"].items()
               if isinstance(v, dict) and v.get("skipped_over_budget")}
    assert skipped == OPTIONAL


def test_stage_results_enrich_and_reemit(monkeypatch, capsys):
    """Each stage runs as ``python -m zeggs_tpu_torch.bench.<stage>``, its
    JSON lands in extra, and the line is printed again after every stage."""
    def fake(argv, timeout):
        assert argv[0] == "-m" and argv[1].startswith("zeggs_tpu_torch.bench.")
        assert argv[argv.index("--device") + 1] == "cpu" and "--tiny" in argv
        return dict(CORE) if _stage_of(argv) == "core" else {"ran": _stage_of(argv)}

    assert _run(monkeypatch, fake, 100000) == 0
    lines = _lines(capsys)
    assert len(lines) == 5  # the headline and one line after each later stage
    last = lines[-1]["extra"]
    for key in OPTIONAL:
        assert last[key]["ran"] == key and "stage_wall_s" in last[key]
    assert last["core"]["correct"] is True


@pytest.mark.parametrize("broken", ["core", "serve"])
def test_failed_stage_is_recorded_and_exits_1(monkeypatch, capsys, broken):
    """A stage that fails is recorded with what it printed; the others still
    run, the last line is printed, and the exit code is 1."""
    def fake(argv, timeout):
        stage = _stage_of(argv)
        if stage == broken:
            raise orch.StageFailed("stage exploded", {"phase": "batched"})
        return dict(CORE) if stage == "core" else {"ran": stage}

    assert _run(monkeypatch, fake, 100000) == 1
    last = _lines(capsys)[-1]
    failed = last["extra"][broken]
    assert "stage exploded" in failed["failed"] and failed["phase"] == "batched"
    assert last["value"] == (None if broken == "core" else CORE["best_fps"])
    assert all(last["extra"][k]["ran"] == k for k in OPTIONAL - {broken})


def test_runaway_stage_costs_at_most_itself(monkeypatch, capsys):
    """A stage that runs to its process's time limit is recorded as failed,
    its limit keeps every later stage's estimate, its watchdog fires before
    the limit, and every later stage still runs."""
    clock = [1000.0]
    monkeypatch.setattr(orch.time, "time", lambda: clock[0])
    log = {}

    def fake(argv, timeout):
        stage = _stage_of(argv)
        log[stage] = (argv, timeout)
        if stage == "core":
            clock[0] += 200.0
            return dict(CORE)
        if stage == "serve":
            clock[0] += timeout
            raise subprocess.TimeoutExpired(argv, timeout)
        clock[0] += 30.0
        return {"ran": stage}

    assert _run(monkeypatch, fake, 1140) == 1
    last = _lines(capsys)[-1]["extra"]
    assert "failed" in last["serve"]
    argv, timeout = log["serve"]
    later = sum(orch.ESTIMATES[k][0] for k in ("streaming", "train", "train_bf16"))
    assert timeout + later <= 1140 - 200, timeout
    assert float(argv[argv.index("--budget") + 1]) + 5 < timeout
    assert all(last[k]["ran"] == k for k in ("streaming", "train", "train_bf16"))


def test_full_run_curve_malformed_is_tolerated(monkeypatch, capsys, tmp_path):
    """`--full-run-curve` summarises a port's curve; any malformed content
    gives no summary, and the run goes on."""
    target = tmp_path / "full_run_curve.json"
    for content in ("not json at all", "[1, 2, 3]", '{"wall_s": null, "total_loss": [1.0]}',
                    '{"total_loss": "oops"}'):
        target.write_text(content)
        assert orch._full_run_summary(target) is None, content
    assert orch._full_run_summary(tmp_path / "missing.json") is None
    assert _run(monkeypatch, lambda argv, timeout: dict(CORE), 5,
                "--full-run-curve", str(target)) == 0
    assert "full_run" not in _lines(capsys)[-1]["extra"]
    target.write_text(json.dumps({"iters_done": 2000, "iters_target": 2000, "completed": True,
                                  "dtype": "float32", "wall_s": 7200.0, "iters_per_s": 3.6,
                                  "total_loss": [5.3, 0.4]}))
    assert _run(monkeypatch, lambda argv, timeout: dict(CORE), 5,
                "--full-run-curve", str(target)) == 0
    summary = _lines(capsys)[-1]["extra"]["full_run"]
    assert summary["completed"] is True and summary["wall_h"] == 2.0
    assert summary["loss_start"] == 5.3 and summary["loss_final"] == 0.4


def test_device_events_reads_the_profilers_raw_events():
    """The busy share's reader: on a CPU-only profile the card ran nothing,
    and the raw events it reads are there."""
    from zeggs_tpu_torch.bench.train import device_events

    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (x @ x).sum()
    assert prof.profiler.kineto_results.events()
    assert device_events(prof) == []


def test_missing_launches_on_a_card_only():
    counts = {"decoder_rollout": 3, "decoder_step": 4, "decoder_train": 8, "gru_cell": 0,
              "mel_spectrogram": 5}
    assert FX.missing_launches(counts, build.KERNELS, torch.device("cuda")) == ["gru_cell"]
    assert FX.missing_launches(counts, build.KERNELS, torch.device("cpu")) == []


# ---------------------------------------------------------------------------
# no card: no CPU fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["", ".core", ".serve", ".streaming", ".train"])
def test_no_card_exits_nonzero_and_prints_no_result(module):
    proc = subprocess.run([sys.executable, "-m", f"zeggs_tpu_torch.bench{module}"],
                          capture_output=True, text=True, timeout=120, cwd=REPO, env=ENV)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr, proc.stderr[-2000:]
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")], proc.stdout


def test_tiny_is_refused_on_the_card():
    proc = subprocess.run([sys.executable, "-m", "zeggs_tpu_torch.bench", "--tiny"],
                          capture_output=True, text=True, timeout=120, cwd=REPO, env=ENV)
    assert proc.returncode == 2 and "--device cpu" in proc.stderr


# ---------------------------------------------------------------------------
# every stage for real, at --device cpu --tiny --quick
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_rehearsal")
    proc = subprocess.run(
        [sys.executable, "-m", "zeggs_tpu_torch.bench", "--device", "cpu", "--tiny", "--quick",
         "--root", str(root / "corpus")],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 5, proc.stdout
    return lines[-1]


def _jax_core_keys():
    """The keys of the JSON line `bench.py`'s ``stage_core`` prints."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "stage_core")
    dicts = [n for n in ast.walk(fn) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "best_fps" for k in n.keys)]
    return {k.value for k in dicts[0].keys}


def _r05():
    return json.loads((REPO / "BENCH_r05.json").read_text())["parsed"]


# the keys the JAX stages print that have no counterpart: XLA's cache and
# ahead-of-time export
XLA_ONLY = {"compile_cache", "aot", "aot_load_s"}
PORT_ADDED = {
    "core": {"batch", "fps8_batch", "seconds_clip", "chain", "best_fps_n", "fps8_n", "lat_n",
             "lat8_n", "lat_cold_n", "sweep", "max_memory_mib", "correct", "checks",
             "launches", "device"},
    "serve": {"device", "launches", "launches_by_phase", "batched_makespan_n",
              "daemon_makespan_n", "daemon_latency_n", "seq_n"},
    "streaming": {"device", "launches", "launches_by_phase", "push_n"},
    "train": {"step_ms_n", "capture_s", "graph_pool_mib", "graph_kernels",
              "eager_step_ms_median", "eager_step_ms_n", "turns_step_ms_median", "busy_share",
              "busy_share_n", "busy_wall_ms", "compute_dtype", "batch", "window",
              "losses_finite", "launches", "device"},
}


def _expected_keys(stage):
    extra = _r05()["extra"]
    if stage == "core":
        return _jax_core_keys() | PORT_ADDED["core"]
    if stage == "serve":
        # r05's serve line was cut by its watchdog in the sequential phase: it
        # has the watchdog's two keys and lacks bench_serve.py's seq_ keys
        jax = (set(extra["serve"]) - {"watchdog_fired", "elapsed_s"}
               | {"seq_p50_s", "seq_p95_s", "seq_p99_s", "seq_clips_per_s"})
        return jax | PORT_ADDED["serve"]
    if stage == "streaming":
        return set(extra["streaming"]) | PORT_ADDED["streaming"]
    # r05's train_bf16 stage timed out: it prints the train stage's keys
    return set(extra["train"]) - XLA_ONLY | PORT_ADDED["train"]


@pytest.mark.parametrize("stage", ["core", "serve", "streaming", "train", "train_bf16"])
def test_stage_keys_are_the_jax_stages(rehearsal, stage):
    out = rehearsal["extra"][stage]
    assert "failed" not in out and "watchdog_fired" not in out, out
    assert set(out) == _expected_keys(stage.replace("_bf16", "")), sorted(out)
    assert out["device"]["platform"] == "cpu"
    assert set(out["launches"]) == set(build.KERNELS)
    if stage == "streaming":
        assert set(out["http"]) == set(_r05()["extra"]["streaming"]["http"]) | {"push_n"}
        assert out["frames"] == out["http"]["frames"] == 300  # 5 s at 60 fps
    if stage == "core":
        assert out["correct"] is True and out["lat_n"] == 5 and out["batch"] == 64
    if stage.startswith("train"):
        assert out["losses_finite"] and out["step_ms_n"] == 3
        assert out["compute_dtype"] == ("bfloat16" if stage == "train_bf16" else "float32")


def test_headline_keys_are_bench_py(rehearsal):
    r05 = _r05()
    assert set(rehearsal) == set(r05)
    # full_run only with --full-run-curve; the device, the rehearsal flag and
    # the core stage's own line are the port's
    assert set(rehearsal["extra"]) == (set(r05["extra"]) - {"full_run"}
                                       | {"device", "rehearsal", "core"})
    assert rehearsal["extra"]["platform"] == "cpu" and rehearsal["extra"]["rehearsal"] is True
    assert rehearsal["value"] == rehearsal["extra"]["core"]["best_fps"] > 0


def test_serve_watchdog_emits_json_under_hard_budget(tmp_path):
    """The serve stage prints a parseable line and exits 0 when its budget
    runs out inside a phase it cannot leave (the watchdog), or it finishes."""
    proc = subprocess.run(
        [sys.executable, "-m", "zeggs_tpu_torch.bench.serve", "--device", "cpu", "--tiny",
         "--requests", "20", "--daemon", "--budget", "0.1", "--root", str(tmp_path / "sb")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=ENV)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1])
    assert out.get("phase") == "done" or out.get("watchdog_fired") is True
    assert "launches" in out and out["device"]["platform"] == "cpu"


# ---------------------------------------------------------------------------
# the fixture's copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_stats_and_initial_state_equal_graft_entry(seed):
    for dims in ((), (FX.POSE_IN, FX.POSE_OUT), (129, 126)):
        a, b = FX._stats(*dims), graft._stats(*dims)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
    for B, J in ((1, FX.NJOINTS), (3, FX.TINY_JOINTS)):
        ours = FX._initial_state(np.random.default_rng(seed), B, J)
        theirs = graft._initial_state(np.random.default_rng(seed), B, J)
        assert len(ours) == len(theirs) == 8
        for x, y in zip(ours, theirs):
            np.testing.assert_array_equal(x, np.asarray(y))
            assert x.dtype == np.float32
    assert (FX.NJOINTS, FX.POSE_IN, FX.POSE_OUT, FX.AUDIO_DIM) == (
        graft.NJOINTS, graft.POSE_IN, graft.POSE_OUT, graft.AUDIO_DIM)


def _describe(requests, total, lengths):
    return {"total": total, "lengths": list(lengths), "requests": [
        [Path(r.audio).name, hashlib.sha256(Path(r.audio).read_bytes()).hexdigest(), r.seed,
         r.file_name, r.temperature, Path(r.styles[0][0]).name, list(r.styles[0][1])]
        for r in requests]}


JAX_DRAW = textwrap.dedent("""
    import json, sys, types
    from pathlib import Path
    sys.path[:0] = ["scripts", "."]
    import jax
    jax.config.update("jax_platforms", "cpu")
    import bench_serve as B
    # the draw only: no networks (their files exist, empty, for the cache)
    B.init_networks = lambda *a, **k: {n: {} for n in ("speech_encoder", "decoder",
                                                       "style_encoder")}
    B.checkpoint = types.SimpleNamespace(save=lambda path, tree: Path(path).write_bytes(b""))
    root, out = Path(sys.argv[1]), {}
    import hashlib
    for seed in (0, 1):
        for branch in ("uncached", "cached"):
            _, _, reqs, total, _, lengths = B.build_corpus(root / f"s{seed}", 20, seed)
            out[f"{seed}_{branch}"] = {"total": total, "lengths": list(lengths), "requests": [
                [Path(r.audio).name, hashlib.sha256(Path(r.audio).read_bytes()).hexdigest(),
                 r.seed, r.file_name, r.temperature, Path(r.styles[0][0]).name,
                 list(r.styles[0][1])] for r in reqs]}
    print(json.dumps(out))
""")


def test_request_draw_equals_bench_serve(tmp_path):
    """The corpus's requests (lengths, WAV bytes, seeds, style windows) are
    `scripts/bench_serve.py`'s for seeds 0 and 1, on its cached and uncached
    branches."""
    proc = subprocess.run([sys.executable, "-c", JAX_DRAW, str(tmp_path / "jax")],
                          capture_output=True, text=True, timeout=300, cwd=REPO,
                          env=dict(ENV, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    theirs = json.loads(proc.stdout.strip().splitlines()[-1])
    for seed in (0, 1):
        root = tmp_path / f"port{seed}"
        for branch in ("uncached", "cached"):
            assert (root / "corpus_marker.txt").exists() == (branch == "cached")
            _, _, reqs, total, _, lengths = FX.build_corpus(root, 20, seed, tiny=True)
            ours = _describe(reqs, total, lengths)
            assert ours == theirs[f"{seed}_{branch}"], (seed, branch)
            assert len(lengths) == 20 and all(240 <= n <= 720 for n in lengths)
