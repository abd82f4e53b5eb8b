"""Streaming sessions of zeggs_tpu_torch on the CPU: against the port's own
offline path, against zeggs_tpu's StreamingSession (frames emitted per
push) and against zeggs_tpu's offline path.

The synthetic corpus of tests/synthetic.py (3 s clips, 8 joints, small
widths, loudness normalisation off as a stream cannot apply it) is read by
both packages from the same files. Budgets: against the port's offline
`generate_gesture` at temperature 1 (the session mirrors its style draws),
BVH position MAE < 1e-4 and rotation MAE < 1e-3 degrees, the bounds of
tests/test_streaming.py; against zeggs_tpu offline at temperature 0 (the
two packages draw different numbers), BVH channels atol 2e-3 with
rotations compared as matrices, the budget of tests/test_torch_batch.py.
"""

import json

import numpy as np
import pytest
import torch

from zeggs_tpu.infer import GesturePipeline as JaxPipeline
from zeggs_tpu.infer import generate_gesture as jax_generate
from zeggs_tpu.io import bvh, wav
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.ops import quat
from zeggs_tpu_torch.ops.kernels import gru_cell as GC
from zeggs_tpu_torch.ops.kernels import mel as MK
from tests.synthetic import write_corpus

NFRAMES = 180
POS_MAE, ROT_MAE = 1e-4, 1e-3
ATOL = 2e-3


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_stream_corpus")
    data_dir, net_dir, clips, opts = write_corpus(root, n_clips=3, nframes=NFRAMES)
    od = opts.to_options_dict()
    pipe = GesturePipeline(net_dir, data_dir, options=TC.Options.from_options_dict(od),
                           device="cpu")
    _, audio = wav.read_wavfile(clips[0][1], rescale=True, desired_fs=16000,
                                out_type="float32")
    return dict(root=root, data=data_dir, nets=net_dir, clips=clips, opts=opts, pipe=pipe,
                audio=np.asarray(audio, np.float32))


def _chunk_plan(total, kind):
    if kind == "whole":
        return [total]
    if kind == "seconds":
        return [min(16000, total - n) for n in range(0, total, 16000)]
    # a random mix of small and large pushes, 7-sample pushes included
    rng = np.random.default_rng(5)
    out, n = [], 0
    while n < total:
        c = min(int(rng.choice([7, 800, 3001, 16000, 40000])), total - n)
        out.append(c)
        n += c
    return out


def _stream(pipe, audio, styles, chunks, **kw):
    """Run a session over the chunk plan -> (session, frames emitted by
    each push and by finish)."""
    sess = pipe.streaming_session(styles, **kw)
    counts, o = [], 0
    for n in chunks:
        counts.append(sess.push(audio[o : o + n])["root_pos"].shape[0])
        o += n
    assert o == len(audio)
    counts.append(sess.finish()["root_pos"].shape[0])
    assert 1 + sum(counts) == sess.frames_emitted == NFRAMES
    return sess, counts


def _offline(c, tmp_path, styles, **kw):
    generate_gesture(c["clips"][0][1], styles, None, None, tmp_path / "offline",
                     file_name="off", pipeline=c["pipe"], **kw)
    return bvh.load(tmp_path / "offline" / "off.bvh")


def _maes(a, b):
    assert a["rotations"].shape == b["rotations"].shape
    assert np.isfinite(b["positions"]).all() and np.isfinite(b["rotations"]).all()
    return (float(np.abs(a["positions"] - b["positions"]).mean()),
            float(np.abs(a["rotations"] - b["rotations"]).mean()))


@pytest.mark.parametrize("quantum", [1, 16])
@pytest.mark.parametrize("kind", ["whole", "seconds", "random"])
def test_streaming_matches_offline(corpus, tmp_path, kind, quantum):
    c = corpus
    styles = [(c["clips"][1][0], (10, 80))]
    kw = dict(temperature=1.0, seed=77)
    ref = _offline(c, tmp_path, styles, **kw)
    sess, _ = _stream(c["pipe"], c["audio"], styles, _chunk_plan(len(c["audio"]), kind),
                      quantum=quantum, **kw)
    pos, rot = _maes(ref, bvh.load(sess.write_bvh(tmp_path / "stream", "str")))
    assert pos < POS_MAE and rot < ROT_MAE, (pos, rot)


def test_streaming_emits_before_finish(corpus):
    """After 1.5 s of audio more than a second of gesture is out (the
    algorithmic lag is about 0.3 s of audio)."""
    c = corpus
    sess = c["pipe"].streaming_session([(c["clips"][2][0], (0, 60))], temperature=1.0, seed=1)
    new = sess.push(c["audio"][:24000])
    assert sess.frames_emitted >= 60 and new["root_pos"].shape[0] >= 59
    sess.push(c["audio"][24000:])
    sess.finish()
    assert sess.frames_emitted == NFRAMES


def test_streaming_blend_and_first_pose(corpus, tmp_path):
    """Two example styles blended with "add" and an explicit first pose."""
    c = corpus
    styles = [(c["clips"][1][0], (10, 80)), (c["clips"][2][0], (0, 60))]
    kw = dict(temperature=1.0, seed=9, blend_ratio=(0.25, 0.75), first_pose=c["clips"][0][0])
    ref = _offline(c, tmp_path, styles, blend_type="add", **kw)
    sess, _ = _stream(c["pipe"], c["audio"], styles, [len(c["audio"])], **kw)
    pos, rot = _maes(ref, bvh.load(sess.write_bvh(tmp_path / "stream", "str")))
    assert pos < POS_MAE and rot < ROT_MAE, (pos, rot)


@pytest.fixture(scope="module")
def jax_pipe(corpus):
    c = corpus
    return JaxPipeline(c["nets"], c["data"], options=c["opts"])


@pytest.mark.parametrize("kind,quantum", [("random", 1), ("seconds", 16), ("random", 16)])
def test_push_counts_match_jax_session(corpus, jax_pipe, kind, quantum):
    c = corpus
    styles = [(c["clips"][1][0], None)]
    plan = _chunk_plan(len(c["audio"]), kind)
    _, ours = _stream(c["pipe"], c["audio"], styles, plan, quantum=quantum, temperature=0.0)
    sess = jax_pipe.streaming_session(styles, quantum=quantum, temperature=0.0)
    theirs, o = [], 0
    for n in plan:
        theirs.append(sess.push(c["audio"][o : o + n])["root_pos"].shape[0])
        o += n
    theirs.append(sess.finish()["root_pos"].shape[0])
    assert ours == theirs


def _matrices(anim):
    """BVH Euler angles (degrees) -> rotation matrices, in float64."""
    rad = torch.deg2rad(torch.as_tensor(anim["rotations"], dtype=torch.float64))
    w, x, y, z = quat.from_euler(rad, anim["order"]).unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).numpy()


def test_streaming_matches_jax_offline(corpus, jax_pipe, tmp_path):
    c = corpus
    styles = [(c["clips"][1][0], None)]
    jax_generate(c["clips"][0][1], styles, None, None, tmp_path / "jax", file_name="ref",
                 temperature=0.0, pipeline=jax_pipe)
    ref = bvh.load(tmp_path / "jax" / "ref.bvh")
    sess, _ = _stream(c["pipe"], c["audio"], styles, _chunk_plan(len(c["audio"]), "seconds"),
                      quantum=16, temperature=0.0)
    got = bvh.load(sess.write_bvh(tmp_path / "stream", "str"))
    assert got["rotations"].shape == ref["rotations"].shape == (NFRAMES, 8, 3)
    np.testing.assert_allclose(_matrices(got), _matrices(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got["positions"], ref["positions"], atol=ATOL, rtol=0)


def test_session_counts_no_launches_on_cpu(corpus):
    """CPU tensors take every kernel's plain version; the session records
    the decoder steps it ran."""
    c = corpus
    before = (MK.launches, GC.launches)
    sess, _ = _stream(c["pipe"], c["audio"], [(c["clips"][1][0], None)],
                      _chunk_plan(len(c["audio"]), "seconds"), quantum=16)
    assert (MK.launches, GC.launches) == before
    assert sess.decoder_steps == NFRAMES - 1


def test_session_does_not_record_autograd(corpus):
    c = corpus
    sess = c["pipe"].streaming_session([(c["clips"][1][0], None)])
    sess.push(c["audio"][:16000])
    assert not sess._carry[0].requires_grad
    assert sess.style.is_inference() and sess._carry[0].is_inference()


def test_rollout_chunking_is_exact(corpus):
    """`decoder.rollout` equals init_carry and chained rollout_chunk calls,
    which is what a session runs."""
    pipe = corpus["pipe"]
    rng = np.random.default_rng(0)
    J, T, B = pipe.njoints, 33, 2

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    state = (t(rng.normal(size=(B, 3))), t(np.tile([1.0, 0, 0, 0], (B, 1))),
             t(rng.normal(size=(B, 3))), t(rng.normal(size=(B, 3))),
             t(rng.normal(size=(B, J, 3))), t(np.tile([[1.0, 0, 0], [0, 1.0, 0]], (B, J, 1, 1))),
             t(rng.normal(size=(B, J, 3))), t(rng.normal(size=(B, J, 3))))
    gaze, speech, style = (t(rng.normal(size=(B, T, n))) for n in (3, 16, 8))
    s = pipe.stats
    stats = (s["anim_input_mean"], s["anim_input_std"], s["anim_output_mean"],
             s["anim_output_std"], pipe.dt)
    dec = pipe.networks["decoder"]
    with torch.inference_mode():
        full = D.rollout(dec, *state, gaze, speech, style, *stats)
        carry = D.init_carry(dec, *state, gaze[:, 0], style[:, 0], *stats[:2])
        outs, o = [], 1
        for n in (5, 1, 20, 6):
            carry, ys = D.rollout_chunk(dec, carry, gaze[:, o : o + n], speech[:, o : o + n],
                                        style[:, o : o + n], *stats)
            outs.append(ys)
            o += n
    assert o == T
    for i in range(8):
        torch.testing.assert_close(full[i][:, 1:], torch.cat([y[i] for y in outs], dim=1),
                                   rtol=2e-5, atol=2e-6)
