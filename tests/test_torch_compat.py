"""The reference's whole-module `.pt` checkpoints in the port
(`zeggs_tpu_torch.io.torch_compat`, `GesturePipeline`'s `.pt` fallback and
the convert / compare / bvh2fbx CLIs) against zeggs_tpu's.

The `.pt` files are built here: JAX parameter trees of each network kind
(zeggs_tpu's own initialisers, seeded) written as reference-layout pickles
by `save_reference_networks`. The port and zeggs_tpu must read them into
the same trees, bit for bit, and those must be the trees written. A
pipeline from a directory of `.pt` files writes the same BVH text as one
from the `.npz` files. compare's numbers agree with zeggs_tpu's within
1e-5 (its joint positions come from each package's own FK).
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from zeggs_tpu.cli import compare as jax_compare
from zeggs_tpu.io import checkpoint as jax_checkpoint
from zeggs_tpu.io import torch_compat as jtc
from zeggs_tpu.models import decoder as jdec
from zeggs_tpu.models import speech_encoder as jse
from zeggs_tpu.models import style_encoder as jste
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.cli import bvh2fbx, compare, convert
from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
from zeggs_tpu_torch.io import bvh, checkpoint
from zeggs_tpu_torch.io import torch_compat as tc
from tests.synthetic import POSE_IN, POSE_OUT, make_motion, write_corpus

REPO = Path(__file__).resolve().parents[1]
KINDS = [("attn", "normal"), ("gru", "normal"), ("attn", "film"), ("gru", "film")]


def _trees(body, cell, seed=0):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    trees = {
        "speech_encoder": jse.init(k1, 81, 16, 12),
        "style_encoder": jste.init(k2, POSE_IN, 24, 8, encoder_type=body, use_vae=True),
        "decoder": jdec.init(k3, POSE_IN, POSE_OUT, 12, 8, 32, 2, cell),
    }
    return jax.tree.map(np.asarray, trees)


def _assert_trees_equal(a, b):
    fa, fb = checkpoint._flatten(a), checkpoint._flatten(b)
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        assert v.shape == fb[k].shape and np.array_equal(v, fb[k]), k


@pytest.mark.parametrize("body,cell", KINDS)
def test_reference_checkpoints_read_as_in_zeggs_tpu(tmp_path, body, cell):
    trees = _trees(body, cell)
    tc.save_reference_networks(tmp_path, trees)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "decoder.pt", "speech_encoder.pt", "style_encoder.pt"]
    ours = tc.load_reference_networks(tmp_path, rnn_cond=cell)
    ref = jtc.load_reference_networks(tmp_path, rnn_cond=cell)
    _assert_trees_equal(ours, ref)
    _assert_trees_equal(ours, trees)
    # the state dicts keep the reference's names, which zeggs_tpu converts
    sd = tc.load_reference_module(tmp_path / "decoder.pt")
    _assert_trees_equal(tc.convert_decoder(sd, cell), jtc.convert_decoder(sd, cell))
    assert tc.load_reference_networks(tmp_path, style_encoding_type="label").keys() == {
        "speech_encoder", "decoder"}


_SHIM_ORDER = """
import sys, numpy as np
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from zeggs_tpu.io import torch_compat as jtc
from zeggs_tpu_torch.io import torch_compat as tc
from zeggs_tpu_torch.io import checkpoint
first, second = (tc, jtc) if {port_first!r} else (jtc, tc)
a = first.load_reference_networks({path!r}, rnn_cond="film")
shim = sys.modules["modules"]
b = second.load_reference_networks({path!r}, rnn_cond="film")
assert sys.modules["modules"] is shim and shim.__zeggs_shim__
fa, fb = checkpoint._flatten(a), checkpoint._flatten(b)
assert fa.keys() == fb.keys() and all(np.array_equal(v, fb[k]) for k, v in fa.items())
print("owner", shim.SpeechEncoder.__module__, len(fa))
"""


@pytest.mark.parametrize("port_first", [True, False])
def test_both_shims_in_one_process(tmp_path, port_first):
    """Whichever package unpickles first installs its `modules` shim; the
    other reuses it and reads the same trees (as under pytest-xdist, where
    both packages' tests share a worker)."""
    tc.save_reference_networks(tmp_path, _trees("gru", "film"))
    code = _SHIM_ORDER.format(repo=str(REPO), port_first=port_first, path=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    owner = proc.stdout.split()[1]
    assert owner == ("modules" if port_first else "zeggs_tpu.io.torch_compat")


def test_writing_under_the_jax_shim(tmp_path):
    """With zeggs_tpu's shim installed, the port still writes pickles that
    both read."""
    jtc._install_modules_shim()
    installed = sys.modules["modules"]
    trees = _trees("attn", "normal", seed=1)
    tc.save_reference_networks(tmp_path, trees)
    assert sys.modules["modules"] is installed
    _assert_trees_equal(jtc.load_reference_networks(tmp_path), trees)
    _assert_trees_equal(tc.load_reference_networks(tmp_path), trees)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("compat_corpus")
    data_dir, net_dir, clips, opts = write_corpus(root, n_clips=2, nframes=120)
    trees = {n: jax_checkpoint.load(net_dir / f"{n}.npz")[0]
             for n in ("speech_encoder", "style_encoder", "decoder")}
    pt_dir = root / "pt_models"
    tc.save_reference_networks(pt_dir, trees)
    return dict(root=root, data=data_dir, nets=net_dir, pt=pt_dir, clips=clips, trees=trees,
                opts=TC.Options.from_options_dict(opts.to_options_dict()))


@pytest.mark.parametrize("layout", ["pt_only", "mixed"])
def test_pipeline_from_pt_files_writes_the_npz_bvh(corpus, tmp_path, layout):
    c = corpus
    nets = c["pt"]
    if layout == "mixed":
        nets = tmp_path / "mixed"
        shutil.copytree(c["pt"], nets)
        shutil.copy(c["nets"] / "speech_encoder.npz", nets / "speech_encoder.npz")
        (nets / "speech_encoder.pt").unlink()
    out = {}
    for tag, path in (("npz", c["nets"]), (layout, nets)):
        pipe = GesturePipeline(path, c["data"], options=c["opts"], device="cpu")
        generate_gesture(c["clips"][1][1], [(c["clips"][0][0], None)], None, None,
                         tmp_path / tag, file_name="clip", temperature=1.0, seed=5, pipeline=pipe)
        out[tag] = (tmp_path / tag / "clip.bvh").read_text()
    assert out["npz"] == out[layout]


def test_pipeline_raises_for_missing_networks(corpus, tmp_path):
    shutil.copy(corpus["pt"] / "decoder.pt", tmp_path / "decoder.pt")
    with pytest.raises(FileNotFoundError, match="speech_encoder"):
        GesturePipeline(tmp_path, corpus["data"], options=corpus["opts"], device="cpu")


def test_convert_cli(corpus, tmp_path, capsys):
    convert.main(["--src", str(corpus["pt"]), "--dst", str(tmp_path)])
    assert capsys.readouterr().out.count("converted") == 3
    for name, tree in corpus["trees"].items():
        ours, meta = checkpoint.load(tmp_path / f"{name}.npz")
        assert meta == {"converted_from": str(corpus["pt"] / f"{name}.pt")}
        _assert_trees_equal(ours, tree)
        _assert_trees_equal(jax_checkpoint.load(tmp_path / f"{name}.npz")[0], tree)
    with pytest.raises(SystemExit):
        convert.main(["--src", str(tmp_path), "--dst", str(tmp_path / "none")])


def test_compare_cli(tmp_path, capsys):
    anim = make_motion(40)
    a, b = tmp_path / "a.bvh", tmp_path / "b.bvh"
    bvh.save(a, anim)
    bvh.save(b, dict(anim, rotations=anim["rotations"] + 0.5))
    for pair in ((a, a), (a, b)):
        ours = compare.compare_bvh(str(pair[0]), str(pair[1]), device="cpu")
        ref = jax_compare.compare_bvh(str(pair[0]), str(pair[1]))
        assert ours.keys() == ref.keys() and ours["comparable"]
        for k, v in ours.items():
            assert v == pytest.approx(ref[k], abs=1e-5), k
    assert ours["rotation_mae_deg"] == pytest.approx(0.5, abs=1e-3)
    assert ours["joint_position_error_mean"] > 0
    compare.main([str(a), str(b), "--json", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == pytest.approx(ours)
    short = tmp_path / "short.bvh"
    bvh.save(short, make_motion(20))
    assert compare.compare_bvh(str(a), str(short), device="cpu") == {
        "comparable": False, "ref_frames": 40, "test_frames": 20}


def test_bvh2fbx_needs_motionbuilder(tmp_path):
    if "pyfbsdk" in sys.modules:
        pytest.skip("MotionBuilder's pyfbsdk is importable")
    with pytest.raises(RuntimeError, match="pyfbsdk"):
        bvh2fbx.bvh2fbx(tmp_path / "a.bvh", None, tmp_path / "t.fbx", tmp_path / "a.fbx")
