"""The rollout programs of zeggs_tpu_torch (`infer/programs.py`) and the
program layer of batched inference (`infer/batch.py`: `resolve_batch_pad`,
`_chunk_b_pad`, `plan_programs`, `warmup`, `generate_batch(batch_pad=...)`)
on the CPU, against zeggs_tpu's and against the port's eager rollout.

On the CPU a program runs its steps eagerly (the plain version of its CUDA
graph), so these tests hold the grain ladder, the carry passed between
programs, the row padding and the session's padded tail to the eager
`rollout_chunk`; tests/test_torch_cuda.py holds the graphs to it on a
card. Budgets: the program ladder against `rollout_chunk`, equal bit for
bit (the same hoisted products and the same step); a padded chunk's real
rows against the unpadded chunk 1e-5 (a matrix product's blocking may
follow the number of rows); a session's padded tail against the tail run
at its own size 1e-5; generate_batch against zeggs_tpu's under the same
policy, BVH channels atol 2e-3 (tests/test_torch_batch.py's budget).
"""

import types
from collections import Counter

import numpy as np
import pytest
import torch

from zeggs_tpu.infer import GesturePipeline as JaxPipeline
from zeggs_tpu.infer import batch as jax_batch
from zeggs_tpu.infer.batch import Request as JaxRequest
from zeggs_tpu.io import wav
from zeggs_tpu_torch.infer import batch as B
from zeggs_tpu_torch.infer.batch import Request
from zeggs_tpu_torch.infer.programs import GRAINS, ProgramCache, ladder, ladder_programs
from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.ops.kernels import build
from zeggs_tpu_torch.utils import profiling
from zeggs_tpu_torch.parallel import create_mesh
from tests.test_torch_batch import BUCKET, NFRAMES, _assert_bvh_close, _port, corpus  # noqa: F401

OUTPUTS = (0, 1, 4, 5)


def _requests(c, cls, n=3):
    return [cls(audio=c["clips"][i % 3][1], styles=[(c["clips"][(i + 1) % 3][0], None)],
                file_name=f"p{i}", temperature=0.0, seed=20 + i) for i in range(n)]


# -- the padding policies and the plan ------------------------------------------


@pytest.mark.parametrize("policy", ["pow2", "full", "auto"])
def test_resolve_batch_pad_matches_jax(policy):
    """"auto" is "pow2" in the port; JAX takes "full" only on a TPU, so on
    the CPU the two agree for every policy."""
    assert B.resolve_batch_pad(policy) == jax_batch.resolve_batch_pad(policy)


def test_resolve_batch_pad_refuses_an_unknown_policy():
    with pytest.raises(ValueError):
        B.resolve_batch_pad("pow3")


@pytest.mark.parametrize("policy", ["pow2", "full"])
def test_chunk_b_pad_matches_jax(policy):
    for max_batch in (1, 2, 3, 5, 8, 64):
        for n_dev in (1, 2, 3, 4, 8):
            for b in range(1, max_batch + 1):
                args = (b, max_batch, n_dev, policy)
                assert B._chunk_b_pad(*args) == jax_batch._chunk_b_pad(*args), args


@pytest.mark.parametrize("policy", ["pow2", "full", "auto"])
def test_plan_programs_matches_jax(policy):
    rng = np.random.default_rng(3)
    grid = [[150, 150, 150], [10, 150], [600] * 64, [240, 600, 720], [1],
            list(rng.integers(1, 2000, 70))]
    for lengths in grid:
        for bucket in (64, 512):
            for max_batch in (1, 3, 8, 64):
                for n_dev in (1, 2, 4):
                    kw = dict(bucket=bucket, max_batch=max_batch, n_dev=n_dev, batch_pad=policy)
                    assert B.plan_programs(lengths, **kw) == jax_batch.plan_programs(lengths, **kw)
    assert B.plan_programs([150] * 3, bucket=64, max_batch=8, batch_pad="full") == [(192, 8)]


# -- warmup ----------------------------------------------------------------------


@pytest.mark.parametrize("cut", ["deadline_passed", "no_deadline"])
def test_warmup_returns_what_jax_returns(corpus, cut):  # noqa: F811
    """A deadline already passed skips every shape and the style encoder;
    none runs each planned chunk: the port captures (on the CPU, makes) the
    programs that chunk's rollout needs."""
    c = corpus
    kw = dict(bucket=BUCKET, max_batch=8)
    if cut == "deadline_passed":
        kw.update(lengths=[150] * 3 + [40], deadline=0.0, all_pow2=True, style_jobs=[(64, 2)])
    else:
        kw.update(lengths=[40])
    port_pipe = _port(c)
    port = B.warmup(port_pipe, **kw)
    jax = jax_batch.warmup(JaxPipeline(c["nets"], c["data"], options=c["opts"]), **kw)
    assert set(port) == set(jax) == {"compiled", "skipped", "seconds", "complete"}
    for key in ("compiled", "skipped", "complete"):
        assert port[key] == jax[key], key
    assert port["seconds"] >= 0.0
    made = {key[1:] for key, _ in port_pipe.programs.programs()}
    if cut == "deadline_passed":
        assert port["complete"] is False and ("style", 64, 2) in port["skipped"]
        assert made == set()
    else:
        # T_pad 64, B_pad 1: 63 steps as 3 x 16, 3 x 4 and 3 x 1
        assert port["compiled"] == [(64, 1)] and port["complete"] is True
        assert made == {(0, 1, g, False) for g in GRAINS}


def test_warmup_over_a_mesh_makes_each_blocks_programs(corpus):  # noqa: F811
    """Two replicas: the chunk of three clips is padded to four rows, and
    each block's slot gets the programs of its two rows."""
    pipe = _port(corpus)
    out = B.warmup(pipe, [150] * 3, bucket=BUCKET, max_batch=8,
                   mesh=create_mesh(devices=["cpu"] * 2))
    assert out["compiled"] == [(192, 4)] and out["complete"]
    made = {key[1:] for key, _ in pipe.programs.programs()}
    assert made == {(slot, 2, g, False) for slot in (0, 1) for g in GRAINS}


# -- generate_batch's padding ------------------------------------------------------


@pytest.mark.parametrize("policy", ["pow2", "full"])
def test_generate_batch_policy_matches_jax(corpus, tmp_path, policy):  # noqa: F811
    """Three requests, max_batch 8: "pow2" pads the chunk to four rows and
    "full" to eight, in both packages."""
    c = corpus
    jax_batch.generate_batch(JaxPipeline(c["nets"], c["data"], options=c["opts"]),
                             _requests(c, JaxRequest), tmp_path / "jax", bucket=BUCKET,
                             max_batch=8, batch_pad=policy)
    B.generate_batch(_port(c), _requests(c, Request), tmp_path / "port", bucket=BUCKET,
                     max_batch=8, batch_pad=policy)
    for i in range(3):
        _assert_bvh_close(tmp_path / "port" / f"p{i}.bvh", tmp_path / "jax" / f"p{i}.bvh")


def test_generate_batch_pads_rows_as_jax_does(corpus, monkeypatch, tmp_path):  # noqa: F811
    """The rows a chunk reaches the rollout with: three requests under
    "full" (max_batch 8) give eight rows, the pad rows the last request's
    frame-0 state and zero gaze, audio and style."""
    c = corpus
    pipe = _port(c)
    seen = []
    rollout_batch = pipe.rollout_batch
    monkeypatch.setattr(pipe, "rollout_batch", lambda *a: seen.append(a) or rollout_batch(*a))
    encode = pipe.encode_speech_batched
    audio_in = []
    monkeypatch.setattr(pipe, "encode_speech_batched", lambda x: audio_in.append(x) or encode(x))
    B.generate_batch(pipe, _requests(c, Request), tmp_path, bucket=BUCKET, max_batch=8,
                     batch_pad="full")
    (state0, gaze, _, style), = seen
    assert all(s.shape[0] == 8 for s in state0) and gaze.shape[0] == style.shape[0] == 8
    for s in state0:
        assert torch.equal(s[3:], s[2:3].expand_as(s[3:]))
    assert not gaze[3:].any() and not style[3:].any() and not audio_in[0][3:].any()
    assert gaze[:3].abs().sum() > 0 and style[:3].abs().sum() > 0


def _rows(pipe, n_rows, T, seed):
    """Random frame-0 states and conditioning of ``n_rows`` clips."""
    rng = np.random.default_rng(seed)
    J, S = pipe.njoints, pipe.networks["speech_encoder"].linear.out_features

    def t(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32))

    q = t(n_rows, 4)
    state0 = (t(n_rows, 3), q / q.norm(dim=-1, keepdim=True), t(n_rows, 3, scale=0.1),
              t(n_rows, 3, scale=0.1), t(n_rows, J, 3), t(n_rows, J, 2, 3),
              t(n_rows, J, 3, scale=0.1), t(n_rows, J, 3, scale=0.1))
    C = pipe.style_encoding_size
    return state0, t(n_rows, T, 3, scale=10.0), t(n_rows, T, S), t(n_rows, T, C)


def test_padded_chunk_rows_equal_the_unpadded_run(corpus):  # noqa: F811
    """Three clips rolled out as three rows and padded to eight ("full",
    max_batch 8): the real rows agree within 1e-5."""
    pipe = _port(corpus)
    state0, gaze, speech, style = _rows(pipe, 3, 64, seed=1)
    pad = 5
    padded = (tuple(torch.cat([s, s[-1:].expand(pad, *s.shape[1:])]) for s in state0),
              *(B._pad_rows(x, pad) for x in (gaze, speech, style)))
    with torch.inference_mode():
        plain = pipe.rollout_batch(state0, gaze, speech, style)
        wide = pipe.rollout_batch(*padded)
    for a, b in zip(plain, wide):
        assert b.shape[0] == 8
        torch.testing.assert_close(b[:3], a, rtol=0, atol=1e-5)


# -- the programs against the eager chunk -------------------------------------------


@pytest.mark.parametrize("quantize_int8", [False, True])
@pytest.mark.parametrize("n", [37, 16, 3, 0])
def test_program_ladder_equals_rollout_chunk(corpus, n, quantize_int8):  # noqa: F811
    """n steps through the cache (37 = 2 x 16 + 4 + 1: three programs and
    the carry passed between them) equal the eager `rollout_chunk` bit for
    bit, trajectories and new carry; the cache made one program a grain of
    the ladder, as `ladder_programs` counts them."""
    pipe = _port(corpus)
    state0, gaze, speech, style = _rows(pipe, 2, n + 1, seed=2)
    s = pipe.stats
    stats = (s["anim_input_mean"], s["anim_input_std"], s["anim_output_mean"],
             s["anim_output_std"], pipe.dt)
    dec = pipe.networks["decoder"]
    with torch.inference_mode():
        carry = D.init_carry(dec, *state0, gaze[:, 0], style[:, 0], *stats[:2])
        args = (carry, gaze[:, 1:], speech[:, 1:], style[:, 1:])
        ref_carry, ref = D.rollout_chunk(dec, *args, *stats, output_indices=OUTPUTS,
                                         quantize_int8=quantize_int8)
        got_carry, got = pipe.programs.rollout_chunk(*args, quantize_int8=quantize_int8)
    for a, b in zip(got + got_carry, ref + ref_carry):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sum(grain * reps for grain, reps in ladder(n)) == n
    assert len(pipe.programs.programs()) == ladder_programs([n]) == {37: 3, 16: 1, 3: 1, 0: 0}[n]


def test_one_program_equals_rollout_chunk(corpus):  # noqa: F811
    """A program of 4 steps run twice over 8 columns, on the CPU its eager
    plain version, equals `rollout_chunk` over those 8 steps."""
    pipe = _port(corpus)
    state0, gaze, speech, style = _rows(pipe, 3, 9, seed=4)
    s = pipe.stats
    stats = (s["anim_input_mean"], s["anim_input_std"], s["anim_output_mean"],
             s["anim_output_std"], pipe.dt)
    dec = pipe.networks["decoder"]
    cache = ProgramCache(dec, s, pipe.dt)
    with torch.inference_mode():
        carry = D.init_carry(dec, *state0, gaze[:, 0], style[:, 0], *stats[:2])
        ref_carry, ref = D.rollout_chunk(dec, carry, gaze[:, 1:], speech[:, 1:], style[:, 1:],
                                         *stats, output_indices=OUTPUTS)
        conditioning, step, plain = D.chunk_step(dec, *stats, pipe.njoints)
        cond = (gaze[:, 1:], *conditioning(speech[:, 1:], style[:, 1:]))
        state = (carry[0][0], carry[0][1].contiguous(), *carry[1:])
        program = cache.program(state, cond, 4)
        outs = tuple(torch.empty_like(r) for r in ref)
        new = program.run(state, cond, outs, 0, 2)
    assert not plain and program.rows == 3 and program.steps == 4
    for a, b in zip(outs + (torch.stack(new[:2]), *new[2:]), ref + ref_carry):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_replays_count_the_launches_they_captured():
    """A replay adds what its graph captured; a launch outside a capture
    adds to the totals and to no stream's tally."""
    stream = types.SimpleNamespace(cuda_stream=0)
    before, tally = build.launches()["gru_cell"], profiling.captured(stream)
    profiling.replayed(Counter())
    assert build.launches()["gru_cell"] == before
    profiling.replayed(Counter({"gru_cell.launches": 16}))
    profiling.count("gru_cell.launches")
    assert build.launches()["gru_cell"] == before + 17
    assert profiling.captured(stream) == tally


# -- the session's padded tail -------------------------------------------------------


def test_session_padded_tail_gives_the_same_frames(corpus):  # noqa: F811
    """Quantum 16: the finish tail padded to the grain of 16 and sliced
    gives the frames of the same tail run at its own size (a session whose
    decoder grain is 1), and every decoder chunk is a 16-step program."""
    c = corpus
    pipe = _port(c)
    _, audio = wav.read_wavfile(c["clips"][0][1], rescale=True, desired_fs=16000,
                                out_type="float32")
    audio = np.asarray(audio, np.float32)
    frames = {}
    for grain in (16, 1):
        sess = pipe.streaming_session([(c["clips"][1][0], None)], seed=3, quantum=16)
        sess._grain_dec = grain
        parts = [sess._collect(0)] + [sess.push(audio[o : o + 16000])
                                      for o in range(0, len(audio), 16000)] + [sess.finish()]
        frames[grain] = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        if grain == 16:
            assert sess.decoder_steps % 16 == 0 and sess.decoder_steps >= sess.frames_emitted - 1
            made = {key[1:] for key, _ in pipe.programs.programs()}
            assert made == {("stream", 1, 16, False)}
    for k, v in frames[16].items():
        assert v.shape == frames[1][k].shape and v.shape[0] == NFRAMES
        np.testing.assert_allclose(v, frames[1][k], rtol=0, atol=1e-5)
