"""The ``film`` decoder cell on the rollout programs (`infer/programs.py`) on
the CPU, where a program runs its steps eagerly (the plain version of its
CUDA graph), at a small width: 8 joints, H 32, speech 16, style 8, 3 rows,
40 frames, seeded random weights.

Budgets:

* the programs' rollout against the plain reference
  (`benchmark/reference/decoder_film.py`): every trajectory within 1e-5
  absolute. Both compute the same float32 products on the same hoisted
  conditioning; they differ in the order of GRU1's sums (the GRU-cell
  kernel's plain version against `F.linear`), an ulp or so a step, which
  the 39 steps carry forward without growing past ~1e-6 at this width.
  The same rollout with bfloat16 products (8 bits of mantissa, ~4e-3 of
  rounding a product) falls well outside it;
* the program ladder against `decoder.rollout_chunk`: equal bit for bit
  (the same hoisted products and the same step);
* `generate_batch` against single requests: the BVH channels' mean
  absolute difference under 1e-4, tests/test_torch_gru_film.py's budget (a
  padded chunk's products may block their rows otherwise, and 150 steps
  carry that forward).
"""

import numpy as np
import pytest
import torch

from benchmark.reference import decoder_film as RF
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.infer import GesturePipeline, generate_gesture
from zeggs_tpu_torch.infer.batch import Request, generate_batch
from zeggs_tpu_torch.infer.programs import ProgramCache, ladder_programs
from zeggs_tpu_torch.io import bvh, checkpoint, weights
from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.utils import profiling
from tests.synthetic import POSE_IN, POSE_OUT, write_corpus

DT = 1.0 / 60.0
B, T, J, S, C, H = 3, 40, 8, 16, 8, 32
OUTPUTS = (0, 1, 4, 5)
#: trajectories of the programs' float32 rollout against the reference
#: (see the module's docstring)
TOLERANCE = 1e-5
STATS = ("anim_input_mean", "anim_input_std", "anim_output_mean", "anim_output_std")


def _case(seed=0):
    """A FiLM decoder of seeded PyTorch-default initialisation, its pose
    statistics, a frame-0 state of B rows and their (B, T) gaze, speech and
    style."""
    torch.manual_seed(seed)
    dec = D.Decoder(POSE_IN, POSE_OUT, S, C, H, 2, "film").eval().requires_grad_(False)
    g = torch.Generator().manual_seed(seed + 1)

    def t(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    stats = dict(zip(STATS, (t(POSE_IN, scale=0.1), t(POSE_IN).abs() + 0.5, t(POSE_OUT, scale=0.1),
                             t(POSE_OUT).abs() * 0.2 + 0.05)))
    q = t(B, 4)
    state0 = (t(B, 3), q / q.norm(dim=-1, keepdim=True), t(B, 3, scale=0.1), t(B, 3, scale=0.1),
              t(B, J, 3), t(B, J, 2, 3), t(B, J, 3, scale=0.1), t(B, J, 3, scale=0.1))
    # a label's style held over the clip, as a request's
    cond = (t(B, T, 3, scale=100.0), t(B, T, S), t(B, 1, C).expand(B, T, C).contiguous())
    return dec, stats, state0, cond


def _reference(dec, stats, state0, cond):
    ref = RF.Decoder(POSE_IN, POSE_OUT, S, C, H)
    ref.load_state_dict(dec.state_dict(), strict=True)
    with torch.no_grad():
        out = RF.rollout(ref, *state0, *cond, *stats.values(), DT)
    return tuple(out[i] for i in OUTPUTS)


def _worst(a, b):
    return max((x.float() - y.float()).abs().max().item() for x, y in zip(a, b))


@pytest.mark.parametrize("products", ["float32", "bfloat16"])
def test_film_programs_match_the_reference(products):
    """float32: the programs' rollout within TOLERANCE of the reference;
    bfloat16 products (the eager rollout at that compute dtype: programs
    run float32 only) fall outside it."""
    dec, stats, state0, cond = _case()
    want = _reference(dec, stats, state0, cond)
    with torch.inference_mode():
        if products == "float32":
            got = ProgramCache(dec, stats, DT).rollout(state0, *cond)
        else:
            got = D.rollout(dec, *state0, *cond, *stats.values(), DT, output_indices=OUTPUTS,
                            compute_dtype=torch.bfloat16)
    err = _worst(got, want)
    print(f"FiLM rollout, {products} products, against the reference: max|diff| {err:.3e}")
    assert all(torch.isfinite(g).all() for g in got)
    assert (err <= TOLERANCE) == (products == "float32")


def test_film_program_chunk_equals_rollout_chunk():
    """The program ladder (two 16-step replays, one of 4, three of 1) against
    the eager `rollout_chunk`: trajectories and carry bit for bit; the
    conditioning the programs hold is the gaze, pre_l0, pre_g0, gammas and
    betas; every step counts in ``programs.rollout_steps``."""
    dec, stats, state0, (gaze, speech, style) = _case(seed=3)
    cache = ProgramCache(dec, stats, DT)
    with torch.inference_mode():
        carry = D.init_carry(dec, *state0, gaze[:, 0], style[:, 0], *list(stats.values())[:2])
        args = (gaze[:, 1:], speech[:, 1:], style[:, 1:])
        ref_carry, ref = D.rollout_chunk(dec, carry, *args, *stats.values(), DT,
                                         output_indices=OUTPUTS)
        before = profiling.counters().get("programs.rollout_steps", 0)
        got_carry, got = cache.rollout_chunk(carry, *args)
        steps = profiling.counters()["programs.rollout_steps"] - before
        conditioning, _, plain = D.chunk_step(dec, *stats.values(), DT, J)
        widths = [c.shape[-1] for c in conditioning(speech, style)]
    assert not plain and widths == [H, 3 * H, 2 * H, 2 * H]
    assert steps == T - 1 and len(cache.programs()) == ladder_programs([T - 1]) == 3
    for a, b in zip(got + got_carry, ref + ref_carry):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("path", ["programs", "rollout"])
def test_film_refuses_int8(path):
    """int8 products run the ``normal`` cell only, through the programs as
    through the eager rollout; the B=1 kernel takes no FiLM decoder."""
    dec, stats, state0, cond = _case()
    with torch.inference_mode(), pytest.raises(ValueError, match="normal"):
        if path == "programs":
            ProgramCache(dec, stats, DT).rollout(state0, *cond, quantize_int8=True)
        else:
            D.rollout(dec, *state0, *cond, *stats.values(), DT, quantize_int8=True)
    assert not D.fused_b1_supported(dec, "film")


# -- generate_batch with a FiLM model -------------------------------------------

@pytest.fixture(scope="module")
def film_corpus(tmp_path_factory):
    """tests/synthetic.py's corpus with a FiLM decoder of the port's seeded
    initialisation in place of its ``normal`` one."""
    root = tmp_path_factory.mktemp("film_programs_corpus")
    data_dir, net_dir, clips, opts = write_corpus(root, n_clips=3, nframes=150)
    torch.manual_seed(12)
    dec = D.Decoder(POSE_IN, POSE_OUT, opts.net.speech_encoder.speech_encoding_size,
                    opts.net.style_encoder.style_encoding_size, opts.net.decoder.nhidden, 2,
                    "film")
    checkpoint.save(net_dir / "decoder.npz", weights.to_jax(dec))
    od = opts.to_options_dict()
    od["net_opt"]["decoder"]["rnn_cond"] = "film"
    return dict(data=data_dir, nets=net_dir, clips=clips, opts=TC.Options.from_options_dict(od))


def test_generate_batch_film_equals_single_requests(film_corpus, tmp_path):
    """Three requests in one padded chunk (B_pad 4, 192 frames) against each
    run alone through `generate_gesture` (B=1 programs: FiLM has no B=1
    kernel): the written BVHs within the budget; the pipeline has a program cache
    and every clip's decoder steps count in ``programs.rollout_steps``."""
    c = film_corpus
    pipe = GesturePipeline(c["nets"], c["data"], options=c["opts"], device="cpu")
    assert pipe.networks["decoder"].rnn_cond == "film" and pipe._fused_fn is None
    assert isinstance(pipe.programs, ProgramCache)
    reqs = [Request(audio=c["clips"][i][1], styles=[(c["clips"][(i + 1) % 3][0], None)],
                    file_name=f"film_{i}", temperature=1.0, seed=31 + i) for i in range(3)]
    before = profiling.counters().get("programs.rollout_steps", 0)
    written = generate_batch(pipe, reqs, tmp_path / "batch", bucket=64)
    assert len(written) == 3
    # one chunk of 4 rows at T_pad 192 (150 frames, bucket 64)
    assert profiling.counters()["programs.rollout_steps"] - before == 191
    for r in reqs:
        generate_gesture(r.audio, r.styles, None, None, tmp_path / "single",
                         file_name=r.file_name, temperature=r.temperature, seed=r.seed,
                         pipeline=pipe)
        a = bvh.load(tmp_path / "batch" / f"{r.file_name}.bvh")
        b = bvh.load(tmp_path / "single" / f"{r.file_name}.bvh")
        for key in ("positions", "rotations"):
            assert np.abs(a[key] - b[key]).mean() < 1e-4, key
