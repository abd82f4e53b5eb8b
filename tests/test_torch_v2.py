"""The v2 (label-style) model and the remat training option of
zeggs_tpu_torch on the CPU, against zeggs_tpu.

* Label-style CSV rows with a first pose, at 19 labels (the released
  dataset's count, so the decoder's style input is 19 wide): `-b` against
  the JAX CLI's `-b`, and `--int8` (the int8 decoder kernel's plain
  version) against the JAX int8 Pallas kernel in interpret mode. Budget:
  BVH positions (cm) and the entries of the rotation matrices atol 2e-3,
  as in tests/test_torch_batch.py.
* remat: the loss and every gradient of a training step with dropout and
  VAE noise equal the step without remat (rtol 1e-5, atol 1e-6), and the
  rematerialised steps draw nothing from the step's generator: its state
  after the backward pass is the same.
"""

import csv
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zeggs_tpu.cli import generate as jax_cli
from zeggs_tpu.infer import GesturePipeline as JaxPipeline
from zeggs_tpu.data import features as jax_features
from zeggs_tpu.io import bvh, checkpoint
from zeggs_tpu.models import decoder as jdec
from zeggs_tpu_torch.cli import generate as cli
from zeggs_tpu_torch.train import loop as tloop
from tests.synthetic import PARENTS, POSE_IN, POSE_OUT, write_corpus
from tests.test_torch_batch import _matrices
from tests.test_torch_train import CONFIGS, _batch, _networks, _opts, _stats, _tt

# the styles of the released ZEGGS dataset
LABELS_19 = ["Agreement", "Angry", "Disagreement", "Distracted", "Flirty", "Happy", "Laughing",
             "Neutral", "Old", "Oration", "Pensive", "Relaxed", "Sad", "Sarcastic", "Scared",
             "Sneaky", "Still", "Threatening", "Tired"]
NFRAMES, H = 90, 128
ATOL = 2e-3
DT = 1.0 / 60.0
ROWS = (("row_first", "Agreement", 1), ("row_last", "Tired", 0))


@pytest.fixture(scope="module")
def v2(tmp_path_factory):
    """A label-style run: the synthetic corpus's speech encoder, a decoder
    whose style input is the one-hot of 19 labels (H=128, so that the int8
    packings fit), options and a CSV of label rows with a first pose."""
    root = tmp_path_factory.mktemp("v2")
    data, nets, clips, opts = write_corpus(root, n_clips=2, nframes=NFRAMES)
    definition = json.loads((data / "data_definition.json").read_text())
    (data / "data_definition.json").write_text(json.dumps({**definition,
                                                           "label_names": LABELS_19}))
    label_nets = root / "label_models"
    label_nets.mkdir()
    shutil.copy(nets / "speech_encoder.npz", label_nets / "speech_encoder.npz")
    checkpoint.save(label_nets / "decoder.npz", jdec.init(
        jax.random.PRNGKey(8), POSE_IN, POSE_OUT, opts.net.speech_encoder.speech_encoding_size,
        len(LABELS_19), H, 2))
    od = opts.to_options_dict()
    od["net_opt"]["decoder"]["nhidden"] = H
    od["train_opt"]["style_encoding_type"] = "label"
    od["paths"] = {"base_path": str(root), "path_processed_data": "processed",
                   "output_dir": str(root / "out"), "models_dir": str(label_nets)}
    (root / "options.json").write_text(json.dumps(od))
    with open(root / "requests.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["base_path", "audio", "style", "file_name", "temperature", "seed", "frames",
                    "first_pose", "generate"])
        for name, label, audio in ROWS:
            w.writerow([str(root), clips[audio][1].name, label, name, "1.0", "3", "",
                        clips[0][0].name, "TRUE"])
    return dict(root=root, data=data, nets=label_nets, clips=clips, opts=opts)


def _assert_bvhs_close(a_dir, b_dir):
    for name, _, _ in ROWS:
        a, b = bvh.load(a_dir / f"{name}.bvh"), bvh.load(b_dir / f"{name}.bvh")
        assert a["rotations"].shape == b["rotations"].shape == (NFRAMES, 8, 3)
        assert np.isfinite(a["rotations"]).all() and np.isfinite(a["positions"]).all()
        np.testing.assert_allclose(_matrices(a), _matrices(b), atol=ATOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(a["positions"], b["positions"], atol=ATOL, rtol=0,
                                   err_msg=name)


def test_label_rows_through_batched_mode_match_jax(v2, tmp_path):
    """Both rows share one length bucket: one B=2 chunk with two one-hot
    styles, the first and the last of 19."""
    c = v2
    argv = ["-o", str(c["root"] / "options.json"), "-c", str(c["root"] / "requests.csv"), "-b",
            "-se", "label"]
    jax_cli.main(argv + ["-p", str(tmp_path / "jax")])
    cli.main(argv + ["-p", str(tmp_path / "port"), "--device", "cpu"])
    _assert_bvhs_close(tmp_path / "port", tmp_path / "jax")


def test_label_rows_through_int8_match_the_jax_int8_kernel(v2, tmp_path):
    """`--int8`: each row is a B=1 rollout through the int8 decoder kernel's
    plain version, against the JAX int8 Pallas kernel in interpret mode on
    the JAX pipeline's inputs, called eagerly as tests/test_torch_int8.py
    calls it (the JAX CLI takes the kernel only on a TPU). Inside the JAX
    pipeline's jit, XLA's fusion moves activations across int8 rounding
    boundaries, so JAX's jitted kernel leaves its own eager kernel, and the
    port's plain version, by more than this budget on these rows."""
    c = v2
    cli.main(["-o", str(c["root"] / "options.json"), "-c", str(c["root"] / "requests.csv"),
              "-se", "label", "--int8", "-p", str(tmp_path / "port"), "--device", "cpu"])
    pipe = JaxPipeline(c["nets"], c["data"], options=c["opts"], style_encoding_type="label")
    s = pipe.stats
    kernel = jdec.make_fused_b1_fn(
        pipe.networks["decoder"], s["anim_input_mean"], s["anim_input_std"],
        s["anim_output_mean"], s["anim_output_std"], pipe.dt, weights_dtype=jnp.int8,
        interpret=True)
    f0 = jax_features.preprocess_animation(bvh.load(c["clips"][0][0]))
    state0 = tuple(jnp.asarray(getattr(f0, k)[0:1]) for k in tloop.POSE_KEYS)
    for name, label, audio in ROWS:
        feats, n = pipe.audio_to_features(c["clips"][audio][1])
        style = jnp.repeat(jnp.asarray(pipe.label_encoding(label))[:, None], n, axis=1)
        gaze = jnp.broadcast_to(jnp.asarray(f0.gaze_pos[0]), (n, 3))[None]
        out = kernel(state0, gaze, pipe._encode_speech(feats), style)
        pipe.write_result(tmp_path / "jax", name, tuple(out[i] for i in (0, 1, 4, 5)))
    _assert_bvhs_close(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("kind", ["attn_normal", "gru_normal", "label"])
def test_remat_draws_nothing_and_changes_no_gradient(kind):
    jopts, topts = _opts(kind)
    remat = dataclasses.replace(topts, train=dataclasses.replace(topts.train, remat=True))
    batch = _tt(_batch(CONFIGS[kind]["style"]))
    results = []
    for opts in (topts, remat):
        _, nets = _networks(jopts, opts)
        generator = torch.Generator().manual_seed(11)
        loss, _ = tloop.make_loss_fn(opts, _stats(), PARENTS, DT)(
            nets, batch, 7500, generator)
        loss.backward()
        results.append((loss.item(), {k: p.grad for k, p in tloop.named_parameters(nets).items()},
                        generator.get_state()))
    (loss, grads, state), (loss_r, grads_r, state_r) = results
    assert torch.equal(state_r, state)
    assert loss_r == pytest.approx(loss, rel=1e-6)
    for k, g in grads.items():
        torch.testing.assert_close(grads_r[k], g, rtol=1e-5, atol=1e-6, msg=k)
