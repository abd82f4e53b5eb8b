"""End-to-end offline generation: zeggs_tpu_torch on the CPU against zeggs_tpu.

The synthetic corpus of tests/synthetic.py (180 frames, 8 joints, small
widths) is read by both packages from the same files. Style draws come
from different generators (jax.random against torch.Generator), so the
comparisons run at temperature 0, the deterministic mu path of both. The
JAX side runs once, in a module-scoped fixture.

Budgets: rollout trajectories MAE < 1e-3 (docs/DESIGN.md section 5); BVH
channels MAE < 1e-3 (positions in cm, Euler angles in degrees); style
encodings atol 2e-5, the model budget of tests/test_torch_models.py.
"""

import csv
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zeggs_tpu.infer import GesturePipeline as JaxPipeline
from zeggs_tpu.infer import generate_gesture as jax_generate
from zeggs_tpu.io import bvh, checkpoint
from zeggs_tpu.models import decoder as jdec
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.cli import generate as cli
from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
from tests.synthetic import LABELS, POSE_IN, POSE_OUT, write_corpus

REPO = Path(__file__).resolve().parents[1]
NFRAMES = 180


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_corpus")
    data_dir, net_dir, clips, opts = write_corpus(root, n_clips=2, nframes=NFRAMES)
    # a decoder whose style input is the label one-hot, for label mode
    label_net = root / "label_models"
    label_net.mkdir()
    checkpoint.save(
        label_net / "decoder.npz",
        jdec.init(jax.random.PRNGKey(4), POSE_IN, POSE_OUT,
                  opts.net.speech_encoder.speech_encoding_size, len(LABELS),
                  opts.net.decoder.nhidden, 2),
    )
    shutil.copy(net_dir / "speech_encoder.npz", label_net / "speech_encoder.npz")
    od = opts.to_options_dict()
    od["paths"] = {"base_path": str(root), "path_processed_data": "processed",
                   "output_dir": str(root / "out"), "models_dir": str(net_dir)}
    (root / "options.json").write_text(json.dumps(od))
    topts = TC.Options.from_options_dict(od)
    return dict(root=root, data=data_dir, nets=net_dir, label_nets=label_net, clips=clips,
                opts=opts, topts=topts)


REQUESTS = {
    "single": dict(styles=[0], blend_type="add", blend_ratio=(0.5, 0.5)),
    "add": dict(styles=[0, 1], blend_type="add", blend_ratio=(0.3, 0.7)),
    "stitch": dict(styles=[0, 1], blend_type="stitch", blend_ratio=(0.4, 0.6)),
}


def _styles(c, idx):
    return [(c["clips"][i][0], None) for i in idx]


@pytest.fixture(scope="module")
def jax_ref(corpus):
    """The JAX package's results at temperature 0: BVHs and encodings of
    each request, and the single request's rollout trajectories."""
    c = corpus
    pipe = JaxPipeline(c["nets"], c["data"], options=c["opts"])
    out_dir = c["root"] / "jax_results"
    encs = {}
    for name, req in REQUESTS.items():
        encs[name] = np.asarray(jax_generate(
            audio_file=c["clips"][1][1], styles=_styles(c, req["styles"]),
            network_path=c["nets"], data_path=c["data"], results_path=out_dir,
            blend_type=req["blend_type"], blend_ratio=req["blend_ratio"], file_name=name,
            temperature=0.0, pipeline=pipe,
        ))
    label_pipe = JaxPipeline(c["label_nets"], c["data"], options=c["opts"],
                             style_encoding_type="label")
    encs["label"] = np.asarray(jax_generate(
        audio_file=c["clips"][1][1], styles=["Happy"], network_path=c["label_nets"],
        data_path=c["data"], results_path=out_dir, style_encoding_type="label",
        first_pose=c["clips"][0][0], file_name="label", pipeline=label_pipe,
    ))

    feats, n = pipe.audio_to_features(c["clips"][1][1])
    speech = pipe._encode_speech(feats)
    vec, f0 = pipe.style_example_from_bvh(c["clips"][0][0])
    style = pipe.encode_style(vec, 0.0)[0]
    gaze = jnp.broadcast_to(jnp.asarray(f0.gaze_pos[0]), (n, 3))[None]
    traj = pipe.rollout(f0, gaze, speech, jnp.repeat(style[:, None], n, axis=1))
    return dict(dir=out_dir, encs=encs, traj=[np.asarray(t) for t in traj])


def _port(c, **kw):
    kw.setdefault("style_encoding_type", "example")
    nets = c["label_nets"] if kw["style_encoding_type"] == "label" else c["nets"]
    return GesturePipeline(nets, c["data"], options=c["topts"], device="cpu", **kw)


def _bvh_mae(a_path, b_path):
    a, b = bvh.load(a_path), bvh.load(b_path)
    assert a["rotations"].shape == b["rotations"].shape
    return max(np.abs(a["positions"] - b["positions"]).mean(),
               np.abs(a["rotations"] - b["rotations"]).mean())


def test_rollout_trajectories_match_jax(corpus, jax_ref):
    c = corpus
    pipe = _port(c)
    with torch.inference_mode():
        feats, n = pipe.audio_to_features(c["clips"][1][1])
        speech = pipe.encode_speech(feats)
        vec, f0 = pipe.style_example_from_bvh(c["clips"][0][0])
        style = pipe.encode_style(vec, 0.0)[0]
        traj = pipe.rollout(f0, f0.gaze_pos[0].expand(n, 3)[None], speech,
                            style[:, None].expand(-1, n, -1).contiguous())
    assert n == NFRAMES
    for name, a, b in zip(("root_pos", "root_rot", "lpos", "lrot"), jax_ref["traj"], traj):
        assert a.shape == tuple(b.shape), name
        assert np.abs(a - b.numpy()).mean() < 1e-3, name


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_generate_gesture_matches_jax(corpus, jax_ref, name, tmp_path):
    """Single style, "add" and "stitch" blends: the same BVH, within budget,
    and the same final style encoding."""
    c, req = corpus, REQUESTS[name]
    enc = generate_gesture(
        audio_file=c["clips"][1][1], styles=_styles(c, req["styles"]), network_path=c["nets"],
        data_path=c["data"], results_path=tmp_path, blend_type=req["blend_type"],
        blend_ratio=req["blend_ratio"], file_name=name, temperature=0.0, pipeline=_port(c),
    )
    ref = jax_ref["encs"][name]
    assert tuple(enc.shape) == ref.shape
    np.testing.assert_allclose(enc.numpy(), ref, atol=2e-5, rtol=0)
    assert bvh.load(tmp_path / f"{name}.bvh")["rotations"].shape[0] == NFRAMES
    assert _bvh_mae(tmp_path / f"{name}.bvh", jax_ref["dir"] / f"{name}.bvh") < 1e-3
    assert (tmp_path / f"{name}.wav").exists()


def test_label_mode_matches_jax(corpus, jax_ref, tmp_path):
    c = corpus
    enc = generate_gesture(
        audio_file=c["clips"][1][1], styles=["Happy"], network_path=c["label_nets"],
        data_path=c["data"], results_path=tmp_path, style_encoding_type="label",
        first_pose=c["clips"][0][0], file_name="label",
        pipeline=_port(c, style_encoding_type="label"),
    )
    np.testing.assert_array_equal(enc.numpy(), jax_ref["encs"]["label"])
    assert _bvh_mae(tmp_path / "label.bvh", jax_ref["dir"] / "label.bvh") < 1e-3


def test_cli_single_pair_matches_jax(corpus, jax_ref, tmp_path):
    c = corpus
    cli.main(["-o", str(c["root"] / "options.json"), "-s", str(c["clips"][0][0]),
              "-a", str(c["clips"][1][1]), "-n", "cli_single", "-t", "0", "-p", str(tmp_path),
              "--device", "cpu"])
    assert _bvh_mae(tmp_path / "cli_single.bvh", jax_ref["dir"] / "single.bvh") < 1e-3


def test_cli_csv_mode(corpus, tmp_path):
    """Rows with generate=FALSE are skipped; a frame range picks part of
    the style example."""
    c = corpus
    rows = [
        dict(audio=c["clips"][0][1].name, style=c["clips"][1][0].name, file_name="row0",
             temperature="0.5", seed="3", frames="20 100", first_pose="", generate="TRUE"),
        dict(audio=c["clips"][1][1].name, style=c["clips"][0][0].name, file_name="row1",
             temperature="1.0", seed="4", frames="", first_pose=c["clips"][0][0].name,
             generate="TRUE"),
        dict(audio=c["clips"][1][1].name, style=c["clips"][0][0].name, file_name="skipped",
             temperature="1.0", seed="5", frames="", first_pose="", generate="FALSE"),
    ]
    table = tmp_path / "requests.csv"
    with open(table, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["base_path", *rows[0]])
        w.writeheader()
        for r in rows:
            w.writerow({"base_path": str(c["root"]), **r})
    out = tmp_path / "out"
    cli.main(["-o", str(c["root"] / "options.json"), "-c", str(table), "-p", str(out),
              "--device", "cpu"])
    for name in ("row0", "row1"):
        anim = bvh.load(out / f"{name}.bvh")
        assert anim["rotations"].shape[0] == NFRAMES
        assert np.isfinite(anim["rotations"]).all()
    assert not (out / "skipped.bvh").exists()


def test_cuda_without_a_card_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GesturePipeline(corpus["nets"], corpus["data"], options=corpus["topts"], device="cuda")


def test_same_seed_is_deterministic(corpus, tmp_path):
    c = corpus
    pipe = _port(c)
    for name, seed in (("a", 7), ("b", 7), ("c", 8)):
        generate_gesture(
            audio_file=c["clips"][1][1], styles=_styles(c, [0]), network_path=None,
            data_path=None, results_path=tmp_path, file_name=name, temperature=1.0,
            seed=seed, pipeline=pipe,
        )
    a, b, other = ((tmp_path / f"{n}.bvh").read_bytes() for n in "abc")
    assert a == b
    assert a != other


def test_embedding_only_mode(corpus):
    c = corpus
    enc = generate_gesture(None, _styles(c, [0, 1]), None, None, None, blend_type="stitch",
                           temperature=0.0, pipeline=_port(c))
    assert isinstance(enc, list) and len(enc) == 2
    assert tuple(enc[0].shape) == (1, c["topts"].net.style_encoder.style_encoding_size)


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['zeggs_tpu'] = None\n"
        "import zeggs_tpu_torch.cli.generate, zeggs_tpu_torch.infer, "
        "zeggs_tpu_torch.infer.batch, zeggs_tpu_torch.ops.kernels.decoder_rollout, "
        "zeggs_tpu_torch.ops.kernels.gru_cell, zeggs_tpu_torch.ops.kernels.build, "
        "zeggs_tpu_torch.infer.streaming, zeggs_tpu_torch.serve, zeggs_tpu_torch.cli.serve, "
        "zeggs_tpu_torch.ops.kernels.mel, zeggs_tpu_torch.io, zeggs_tpu_torch.io.native, "
        "zeggs_tpu_torch.audio.loudness, chip_smoke\n"
        "assert not any(m.split('.')[0] in ('jax', 'zeggs_tpu') for m in sys.modules "
        "if sys.modules[m] is not None)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
