"""The port's full-recipe training CLI (`zeggs_tpu_torch/cli/train_full.py`,
the counterpart of `scripts/train_full.py`) on the CPU at narrow widths.

Its corpus is byte-equal to tests/synthetic.py's raw corpus; a 30-step run
writes the curve schema of zeggs_tpu's record docs/fp32_10k_curve.json (the
same keys in the same order), with the KL weight of zeggs_tpu's formula
(within float32 rounding, rtol 1e-6: the two packages' exp differ by an
ulp) and its ExpLR scale exactly; a time budget stops the run with a
checkpoint and ``completed: false``; a resume merges the curve with no
duplicate point and no gap; a curve file with schema drift is ignored."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from zeggs_tpu.train.loss import generalized_logistic_function as jax_glf
from zeggs_tpu_torch import config as C
from zeggs_tpu_torch.cli import train_full as T
from tests.synthetic import write_raw_corpus

REPO = Path(__file__).resolve().parent.parent
JAX_CURVE = REPO / "docs" / "fp32_10k_curve.json"
ITERS, LOG_EVERY, CKPT_EVERY = 30, 5, 10


def narrow_options(dtype, ckpt_every):
    """The recipe at tests/synthetic.py's narrow widths, batch 4 x 32."""
    return C.Options(
        net=C.NetworkConfig(
            decoder=C.DecoderConfig(nhidden=32),
            speech_encoder=C.SpeechEncoderConfig(nhidden=16, speech_encoding_size=16),
            style_encoder=C.StyleEncoderConfig(nhidden=24, style_encoding_size=8,
                                               example_length=64)),
        train=C.TrainConfig(batchsize=4, window=32, seed=1234, compute_dtype=dtype,
                            generate_samples_step=ckpt_every, use_tensorboard=False,
                            resume=True))


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """The recipe's corpus (`build_corpus`: 6 clips of 8 s) on the CPU, built once."""
    root = tmp_path_factory.mktemp("recipe_corpus")
    return T.build_corpus(root, device="cpu")


@pytest.fixture
def run(processed, tmp_path, monkeypatch):
    """``run(*flags)`` runs the CLI at narrow widths in a run root that shares
    the module's corpus -> (curve dict, trainer)."""
    monkeypatch.setattr(T, "recipe_options", narrow_options)
    root = tmp_path / "run"
    root.mkdir()
    (root / "processed").symlink_to(processed)

    def go(*flags):
        trainer = T.main(["--root", str(root), "--device", "cpu", "--dtype", "float32",
                          "--log-every", str(LOG_EVERY), "--ckpt-every", str(CKPT_EVERY),
                          *flags])
        return json.loads((root / "full_run_curve.json").read_text()), trainer

    go.root = root
    return go


def test_corpus_files_equal_the_test_corpus(tmp_path):
    ours = T.write_raw_corpus(tmp_path / "port", n_clips=2, seconds=4.0)
    ref = write_raw_corpus(tmp_path / "jax", n_clips=2, seconds=4.0)
    names = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    assert len(names) == 2 * 3 + 1
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name


def test_a_run_writes_the_jax_curve_schema(run):
    curve, trainer = run("--iters", str(ITERS))
    assert list(curve) == list(json.loads(JAX_CURVE.read_text()))
    assert curve["iters_logged"] == list(range(0, ITERS, LOG_EVERY))
    assert curve["completed"] is True and curve["iters_done"] == trainer.iteration == ITERS
    assert (curve["iters_target"], curve["log_every"], curve["ckpt_every"], curve["dtype"]) == (
        ITERS, LOG_EVERY, CKPT_EVERY, "float32")
    assert curve["recipe"] == json.loads(JAX_CURVE.read_text())["recipe"]
    for k in T.TERM_KEYS + ("kl_weight", "lr_scale"):
        assert len(curve[k]) == len(curve["iters_logged"]) and np.isfinite(curve[k]).all(), k
    jax_kl = [min(float(jax_glf(np.float32(i), center=7500.0, growth=0.005)), 0.2)
              for i in curve["iters_logged"]]
    np.testing.assert_allclose(curve["kl_weight"], jax_kl, rtol=1e-6, atol=0)
    assert curve["lr_scale"] == [0.995 ** (i // 1000) for i in curve["iters_logged"]]
    # checkpoints at every --ckpt-every and the final state, samples from pinned examples
    models = run.root / "models"
    assert sorted(int(p.name) for p in models.iterdir() if p.name.isdigit()) == [0, 10, 20, 30]
    assert len(list((run.root / "logs" / "samples").glob("iteration_10_*.bvh"))) == 12


def test_kl_weight_follows_jax_over_the_whole_schedule():
    steps = list(range(0, 160_001, 499))
    ours = [T.kl_weight(i) for i in steps]
    ref = [min(float(jax_glf(np.float32(i), center=7500.0, growth=0.005)), 0.2) for i in steps]
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    assert max(ours) == 0.2 and ours[0] < 1e-16


@pytest.fixture
def clock():
    """A wall clock that advances one second a train step, until its
    ``undo()``."""
    now = [1e6]
    step = T.Trainer.train_step

    def counted(self, inputs):
        now[0] += 1.0
        return step(self, inputs)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(T.Trainer, "train_step", counted)
        patch.setattr(time, "time", lambda: now[0])
        yield patch


def test_a_spent_budget_checkpoints_and_marks_the_curve_partial(run, clock):
    # 10 s: the step of iteration 10 (logged, and due a checkpoint) ends at 11 s
    curve, trainer = run("--iters", str(ITERS), "--max-hours", str(10 / 3600))
    assert curve["completed"] is False and curve["iters_done"] == trainer.iteration == 10
    assert curve["iters_logged"] == [0, 5, 10]
    meta = json.loads((run.root / "models" / "checkpoint.json").read_text())
    assert meta["step"] == 10 and (run.root / "models" / "10").is_dir()


def test_a_resume_merges_the_curve_without_duplicate_or_gap(run, clock):
    first, _ = run("--iters", str(ITERS), "--max-hours", str(10 / 3600))
    clock.undo()
    merged, trainer = run("--iters", str(ITERS))
    assert merged["completed"] is True and trainer.iteration == ITERS
    assert merged["iters_logged"] == list(range(0, ITERS, LOG_EVERY))
    # the points before the resumed iteration are the first run's, unchanged
    for k in T.TERM_KEYS:
        assert merged[k][:2] == first[k][:2], k
    assert merged["wall_s"] > first["wall_s"]
    # a completed run resumed to more iterations: nothing trimmed, nothing twice
    more, _ = run("--iters", str(ITERS + 10))
    assert more["iters_logged"] == list(range(0, ITERS + 10, LOG_EVERY))
    assert more["total_loss"][: len(merged["total_loss"])] == merged["total_loss"]


def test_a_drifted_curve_file_is_ignored(run):
    run("--iters", "20")
    path = run.root / "full_run_curve.json"
    drifted = json.loads(path.read_text())
    del drifted["loss_gaze"]
    drifted["wall_s"] = 1e9
    path.write_text(json.dumps(drifted))
    curve, _ = run("--iters", str(ITERS))
    assert curve["iters_logged"] == [20, 25] and len(curve["loss_gaze"]) == 2
    assert curve["wall_s"] < 1e6  # the drifted file's wall time is not carried over


def test_the_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--root", str(tmp_path / "run"), "--iters", "1"])
    assert not (tmp_path / "run").exists()
