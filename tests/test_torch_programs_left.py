"""The port's last programs on the CPU at narrow widths, held to zeggs_tpu's:
the recipe's curve and anneal runs (`cli/train_curve.py`,
`cli/train_anneal.py`), the five profilers (`profilers/`) and the
quickstart (`examples/quickstart.py`).

* The synthetic corpus of `data/synthetic.py` is byte-equal to
  tests/synthetic.py's, and `small_options` equals it field by field.
* The curves have the schemas of docs/loss_curve.json and
  docs/anneal_curve.json (the same keys in the same order); ten recipe
  steps from the same weights and batches give zeggs_tpu's Trainer's total
  losses within rtol 1e-4 (tests/test_torch_quality.py's tolerance; both
  losses deterministic: no dropout, style = mu); the verdicts pass on the
  two JAX records and fail on a flat curve, a bfloat16 curve 20% off, a
  NaN, a curve that does not fall and a post-anneal blow-up.
* Each profiler runs with ``--device cpu --tiny`` and prints its lines and
  its ``*_DONE`` marker; the seeded inputs are byte-equal to what the JAX
  scripts' code draws (built here with the same `default_rng(0)` calls);
  the B=1 profile's bfloat16 and int8 rollouts on the CPU (the kernel's
  plain version) stay within the budgets of tests/test_torch_decoder.py
  (atol 3e-4 / rtol 1e-3) and tests/test_torch_int8.py (pose MAE 1e-4)
  against JAX's Pallas kernel in interpret mode.
* The roofline: the v1 decoder cell's product weights are 18,910,208 (the
  JAX script's constant); one eager narrow step's FLOPs are within 1% of
  the products' count derived here from the widths; the bytes follow the
  documented formula.
* The quickstart runs end to end on the CPU (3 iterations here) and leaves
  a BVH of round(60 x 4 s) frames and an HTTP response carrying a BVH.
* Every entry point defaults to the card and, without one, raises before
  it writes anything.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from tests import synthetic as jsyn
from zeggs_tpu import config as JC
from zeggs_tpu.models import decoder as jdec
from zeggs_tpu.train import loop as jloop
from zeggs_tpu.train.loss import generalized_logistic_function as jax_glf
from zeggs_tpu_torch.bench import fixture as FX
from zeggs_tpu_torch.bench.train import Step
from zeggs_tpu_torch.cli import train_anneal as A
from zeggs_tpu_torch.cli import train_curve as C
from zeggs_tpu_torch.cli import train_full as T
from zeggs_tpu_torch.data import synthetic
from zeggs_tpu_torch.examples import quickstart
from zeggs_tpu_torch.io import bvh, weights
from zeggs_tpu_torch.models import decoder as tdec
from zeggs_tpu_torch.models.decoder import Decoder
from zeggs_tpu_torch.profilers import common, fused_b1_profile, grad_profile, loss_profile
from zeggs_tpu_torch.profilers import train_roofline, train_step_profile
from zeggs_tpu_torch.train import loop as tloop

REPO = Path(__file__).resolve().parent.parent
LOSS_CURVE = REPO / "docs" / "loss_curve.json"
ANNEAL_CURVE = REPO / "docs" / "anneal_curve.json"
SHARED_STEPS = 10


def narrow_options(dtype, ckpt_every):
    """The recipe's options (`train_full.recipe_options`) at `small_options`'
    widths (batch 4 x 32)."""
    opts = synthetic.small_options()
    return dataclasses.replace(opts, train=dataclasses.replace(
        opts.train, seed=1234, compute_dtype=dtype, generate_samples_step=ckpt_every,
        use_tensorboard=False, resume=True))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The recipe's corpus (`build_corpus`: 6 clips of 8 s) on the CPU."""
    return synthetic.build_corpus(tmp_path_factory.mktemp("recipe"), device="cpu")


def _run_root(corpus, tmp_path):
    root = tmp_path / "run"
    root.mkdir()
    (root / "processed").symlink_to(corpus)
    return root


# -- the corpus --------------------------------------------------------------


@pytest.mark.parametrize("n_clips,seconds", [(3, 4.0), (6, 8.0)])
def test_corpus_files_equal_the_test_corpus(tmp_path, n_clips, seconds):
    ours = synthetic.write_raw_corpus(tmp_path / "port", n_clips=n_clips, seconds=seconds)
    ref = jsyn.write_raw_corpus(tmp_path / "jax", n_clips=n_clips, seconds=seconds)
    names = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    assert len(names) == 3 * n_clips + 1
    for name in names:
        assert (ours / name).read_bytes() == (ref / name).read_bytes(), name


def test_small_options_equal_the_test_options():
    ours, ref = synthetic.small_options().to_options_dict(), jsyn.small_options().to_options_dict()
    assert ours == ref


# -- the recipe's curve --------------------------------------------------------


def test_a_short_curve_writes_the_jax_schema(corpus, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(T, "recipe_options", narrow_options)
    root = _run_root(corpus, tmp_path)
    code = C.main(["--root", str(root), "--device", "cpu", "--iters", "12"])
    curve = json.loads((root / "loss_curve.json").read_text())
    assert list(curve) == list(json.loads(LOSS_CURVE.read_text()))
    assert curve["iters"] == 12
    for dtype in C.DTYPES:
        assert len(curve[dtype]) == 12 and np.isfinite(curve[dtype]).all(), dtype
    # 12 narrow steps do not halve the loss: the verdict runs and fails
    assert code == 1 and "FAILED: fp32 loss did not decrease materially" in capsys.readouterr().out


def test_ten_steps_follow_the_jax_trainer(corpus, tmp_path, monkeypatch):
    """Both packages' Trainers run SHARED_STEPS recipe steps from the same
    initial weights over the same batches (the same seed draws the same
    windows and example lengths in both), each with its deterministic loss:
    the total losses agree within rtol 1e-4."""
    jax_loss_fn, port_loss_fn = jloop.make_loss_fn, tloop.make_loss_fn
    monkeypatch.setattr(jloop, "make_loss_fn", lambda *a, **k: jax_loss_fn(*a, deterministic=True))
    monkeypatch.setattr(tloop, "make_loss_fn",
                        lambda *a, **k: port_loss_fn(*a, deterministic=True))
    monkeypatch.setattr(jloop.Trainer, "generate_samples", lambda *a, **k: None)
    monkeypatch.setattr(tloop.Trainer, "generate_samples", lambda *a, **k: None)

    jopts = JC.Options.from_options_dict(narrow_options("float32", 10**9).to_options_dict())
    jt = jloop.Trainer(jopts, tmp_path / "jm", tmp_path / "jl", corpus / "processed_data.npz",
                       corpus / "data_definition.json")
    initial = jax.tree.map(np.asarray, jt.params)
    jax_losses = []
    jt.run(max_iterations=SHARED_STEPS,
           on_step=lambda i, m: jax_losses.append(float(m["total_loss"])))

    init_networks = tloop.init_networks

    def from_jax(*args, **kw):
        nets = init_networks(*args, **kw)
        for name, module in nets.items():
            module.load_state_dict(weights.from_jax(initial[name]), strict=True)
        return nets

    monkeypatch.setattr(tloop, "init_networks", from_jax)
    monkeypatch.setattr(T, "recipe_options", narrow_options)
    ours = C.run(corpus, "float32", SHARED_STEPS, torch.device("cpu"))
    assert len(ours) == len(jax_losses) == SHARED_STEPS
    np.testing.assert_allclose(ours, jax_losses, rtol=1e-4)


def test_the_curve_verdict():
    record = json.loads(LOSS_CURVE.read_text())
    assert C.verdict(record) == []
    head, tail = C.head_tail(record["float32"])
    assert round(head, 3) == 5.290 and round(tail, 3) == 1.117
    flat = [5.0] * 400
    assert C.verdict({"float32": flat, "bfloat16": flat}) == ["fp32 loss did not decrease "
                                                              "materially"]
    off = {"float32": record["float32"], "bfloat16": [1.2 * x for x in record["float32"]]}
    assert C.verdict(off) == ["bf16 diverges from fp32"]
    nan = {"float32": record["float32"][:-1] + [float("nan")], "bfloat16": record["bfloat16"]}
    assert len(C.verdict(nan)) == 2


# -- the anneal run ------------------------------------------------------------


def test_an_anneal_run_writes_the_jax_schema(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(T, "recipe_options", narrow_options)
    root = _run_root(corpus, tmp_path)
    A.main(["--root", str(root), "--device", "cpu", "--iters", "30", "--log-every", "5"])
    curve = json.loads((root / "anneal_curve.json").read_text())
    record = json.loads(ANNEAL_CURVE.read_text())
    assert list(curve) == list(record)
    assert {k: curve[k] for k in ("iters", "log_every", "dtype", "kl_center",
                                  "iters_logged_len")} == {
        "iters": 30, "log_every": 5, "dtype": "float32", "kl_center": 7500,
        "iters_logged_len": 6}
    for k in (*A.LOG_KEYS, "kl_weight"):
        assert len(curve[k]) == 6 and np.isfinite(curve[k]).all(), k
    jax_kl = [min(float(jax_glf(np.float32(i), center=7500.0, growth=0.005)), 0.2)
              for i in range(0, 30, 5)]
    np.testing.assert_allclose(curve["kl_weight"], jax_kl, rtol=1e-6, atol=0)


def test_the_anneal_checks():
    record = json.loads(ANNEAL_CURVE.read_text())
    assert A.checks(record) == []
    head, floor, tail = A.readings(record)
    assert (round(head, 3), round(floor, 3), round(tail, 3)) == (4.761, 0.173, 0.131)

    def with_total(total):
        return {**record, "total_loss": total}

    tot = record["total_loss"]
    nan = {**record, "loss_kl_div": record["loss_kl_div"][:-1] + [float("nan")]}
    assert A.checks(nan) == ["non-finite value in training curve"]
    assert "loss did not decrease materially over the run" in A.checks(
        with_total([tot[0]] * len(tot)))
    blown = tot[: len(tot) - 100] + [tot[len(tot) // 2 - 1] * 2 + 0.5] * 100
    assert A.checks(with_total(blown)) == [
        "post-anneal loss blew up relative to the pre-anneal floor"]


# -- the profilers ---------------------------------------------------------------


@pytest.mark.parametrize("module,argv,lines", [
    (loss_profile, ["all"], ["full compute_loss fwd: eager", "xform_fk_vel fwd: eager",
                             "decoder rollout fwd fp32: eager", "LOSSPROFILE_DONE"]),
    (grad_profile, ["all", "all2", "all3", "all4"],
     ["grad(rollout L2) fp32: eager", "grad(compute_loss wrt outputs): eager",
      "grad(style encoder): eager", "value_and_grad(full loss_fn): eager",
      "value_and_grad(no dropout): eager", "grad(full loss_fn WITH dropout, Philox): eager",
      "bernoulli (4, 4, 64, 64) Philox (torch.Generator): eager",
      "step eager (make_train_step): eager", "step replay (TrainProgram): eager",
      "GRADPROFILE_DONE"]),
    (train_step_profile, ["all"], ["fwd-only loss (fp32): eager", "full step (bf16) eager:",
                                   "full step (bf16) replay:", "PROFILE_DONE"]),
    (fused_b1_profile, ["2"], ["scan (fp32 programs): eager", "fused kernel (bf16): eager",
                               "fused kernel (int8): eager",
                               "root_pos  MAE vs fp32: scan 0.000e+00",
                               "weight-streaming bound", "FUSED_B1_PROFILE_DONE"]),
    (train_roofline, ["--bf16"], ["peak used: bfloat16 989 TFLOP/s", "bytes_accessed: None",
                                  "fraction_of_bound: ", "TRAIN_ROOFLINE_DONE"]),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_profiler_runs_on_the_cpu(module, argv, lines, capsys):
    extra = ["--measured-ms", "1.0"] if module is train_roofline else ["--reps", "2"]
    out = module.main(argv + extra + ["--device", "cpu", "--tiny"])
    printed = capsys.readouterr().out.splitlines()
    for text in lines:
        assert any(p.strip().startswith(text) for p in printed), (text, printed)
    assert printed[-1] == lines[-1]
    assert out["device"]["platform"] == "cpu"


def _jax_pose_targets(B, T, J):
    """`scripts/loss_profile.py`'s and `scripts/grad_profile.py`'s
    module-level draws, as the scripts make them."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, T, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    W = {
        "root_pos": jnp.asarray(rng.normal(size=(B, T, 3)).astype(np.float32)),
        "root_rot": jnp.asarray(q),
        "root_vel": jnp.asarray(rng.normal(size=(B, T, 3)).astype(np.float32)),
        "root_vrt": jnp.asarray(rng.normal(size=(B, T, 3)).astype(np.float32)),
        "lpos": jnp.asarray(rng.normal(size=(B, T, J, 3)).astype(np.float32)),
        "ltxy": jnp.asarray(rng.normal(size=(B, T, J, 2, 3)).astype(np.float32)),
        "lvel": jnp.asarray(rng.normal(size=(B, T, J, 3)).astype(np.float32)),
        "lvrt": jnp.asarray(rng.normal(size=(B, T, J, 3)).astype(np.float32)),
    }
    gaze = jnp.asarray(rng.normal(size=(B, T, 3)).astype(np.float32))
    return rng, q, W, gaze


def _same_bytes(ours, ref):
    assert np.asarray(ours).dtype == np.asarray(ref).dtype
    assert np.asarray(ours).tobytes() == np.asarray(ref).tobytes()


def test_loss_profile_inputs_equal_the_scripts():
    B, T, J = 32, 256, 75
    jrng, jq, jW, jgaze = _jax_pose_targets(B, T, J)
    rng = np.random.default_rng(0)
    q, W, gaze = common.pose_targets(rng, B, T, J)
    _same_bytes(q, jq)
    assert list(W) == list(jW)
    for k in W:
        _same_bytes(W[k], jW[k])
    _same_bytes(gaze, jgaze)
    # the rollout section's (and grad_profile's module-level) speech and style
    for ours in common.encodings(rng, B, T, FX.width().options.net):
        _same_bytes(ours, jnp.asarray(jrng.normal(size=(B, T, 64)).astype(np.float32)))


def test_grad_profile_draws_equal_the_scripts():
    """Setup's draws and the sections' (stylegrad's examples, then each
    full-loss section's batch) in the script's order, at the --tiny shapes."""
    S = grad_profile.Setup(torch.device("cpu"), tiny=True)
    B, T, J = S.B, S.T, S.J
    jrng, _, jW, jgaze = _jax_pose_targets(B, T, J)
    net = S.w.options.net
    speech = jrng.normal(size=(B, T, net.speech_encoder.speech_encoding_size)).astype(np.float32)
    style = jrng.normal(size=(B, T, net.style_encoder.style_encoding_size)).astype(np.float32)
    for k in S.W_np:
        _same_bytes(S.W_np[k], jW[k])
    _same_bytes(S.gaze_np, jgaze)
    _same_bytes(S.speech.numpy(), speech)
    _same_bytes(S.style.numpy(), style)
    # stylegrad's examples, then fullgrad's batch: audio, then examples
    _same_bytes(S.rng.normal(size=(B, 2 * T, S.w.pose_in)).astype(np.float32),
                jrng.normal(size=(B, 2 * T, S.w.pose_in)).astype(np.float32))
    batch = S.batch()
    _same_bytes(batch["audio_features"], jrng.normal(size=(B, T, 81)).astype(np.float32))
    _same_bytes(batch["example"], jrng.normal(size=(B, 2 * T, S.w.pose_in)).astype(np.float32))
    assert (batch["example_lengths"] == T).all() and batch["gaze_pos"] is S.gaze_np


def test_train_step_profile_batch_equals_the_scripts():
    B, T = 32, 256
    rng = np.random.default_rng(0)
    q = rng.normal(size=(B, T, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    ref = {
        "audio_features": rng.normal(size=(B, T, 81)).astype(np.float32),
        "root_pos": rng.normal(size=(B, T, 3)).astype(np.float32),
        "root_rot": q,
        "root_vel": rng.normal(size=(B, T, 3)).astype(np.float32) * 0.1,
        "root_vrt": rng.normal(size=(B, T, 3)).astype(np.float32) * 0.1,
        "lpos": rng.normal(size=(B, T, 75, 3)).astype(np.float32),
        "ltxy": rng.normal(size=(B, T, 75, 2, 3)).astype(np.float32),
        "lvel": rng.normal(size=(B, T, 75, 3)).astype(np.float32) * 0.1,
        "lvrt": rng.normal(size=(B, T, 75, 3)).astype(np.float32) * 0.1,
        "gaze_pos": rng.normal(size=(B, T, 3)).astype(np.float32),
        "example": rng.normal(size=(B, 512, graft.POSE_IN)).astype(np.float32),
        "example_lengths": np.full(B, 256, np.int32),
    }
    ours = train_step_profile.batch_of(B, T)
    assert list(ours) == list(ref)
    for k in ref:
        _same_bytes(ours[k], ref[k])


def test_fused_b1_profile_inputs_equal_the_scripts():
    T = 600
    rng = np.random.default_rng(0)
    state0 = graft._initial_state(rng, 1, graft.NJOINTS)
    audio = rng.normal(size=(1, T, graft.AUDIO_DIM)).astype(np.float32)
    gaze = rng.normal(size=(1, T, 3)).astype(np.float32)
    style = rng.normal(size=(1, T, 64)).astype(np.float32)
    ours = fused_b1_profile.inputs(FX.width(), T)
    assert len(ours[0]) == len(state0) == 8
    for a, b in zip(ours[0], state0):
        _same_bytes(a, b)
    for a, b in zip(ours[1:], (audio, gaze, style)):
        _same_bytes(a, b)


@pytest.fixture(scope="module")
def b1_case():
    """The B=1 profile's decoder at the --tiny width with zeggs_tpu's weights,
    and 24 frames of its inputs (the speech through the port's encoder)."""
    w = FX.width(tiny=True)
    net = w.options.net
    S, C_, H = (net.speech_encoder.speech_encoding_size, net.style_encoder.style_encoding_size,
                net.decoder.nhidden)
    params = jdec.init(jax.random.PRNGKey(3), w.pose_in, w.pose_out, S, C_, H, 2, "normal")
    dec = Decoder(w.pose_in, w.pose_out, S, C_, H)
    dec.load_state_dict(weights.from_jax(jax.tree.map(np.asarray, params)))
    state0, audio, gaze, style = fused_b1_profile.inputs(w, 24)
    nets = tloop.init_networks(w.options, w.dims, nlabels=19, seed=0, device="cpu")
    with torch.no_grad():
        speech = nets["speech_encoder"](torch.as_tensor(audio)).numpy()
    stats = FX._stats(w.pose_in, w.pose_out)
    stats = tuple(stats[k] for k in ("anim_input_mean", "anim_input_std", "anim_output_mean",
                                     "anim_output_std"))
    return params, dec.eval(), stats, state0, (gaze, speech, style)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_fused_b1_profile_rollouts_match_the_pallas_kernel(b1_case, dtype):
    params, dec, stats, state0, cond = b1_case
    j = lambda arrs: tuple(jnp.asarray(a) for a in arrs)  # noqa: E731
    t = lambda arrs: tuple(torch.as_tensor(a) for a in arrs)  # noqa: E731
    ref = jdec.make_fused_b1_fn(params, *j(stats), FX.DT, weights_dtype=getattr(jnp, dtype),
                                interpret=True)(j(state0), *j(cond))
    with torch.no_grad():
        ours = tdec.make_fused_b1_fn(dec, *t(stats), FX.DT,
                                     weights_dtype=getattr(torch, dtype))(t(state0), *t(cond))
    for i, (a, b) in enumerate(zip(ref, ours)):
        a = np.asarray(a)
        assert tuple(b.shape) == a.shape, i
        if dtype == "int8":
            assert float(np.mean(np.abs(b.numpy() - a))) < 1e-4, i
        else:
            np.testing.assert_allclose(b.numpy(), a, atol=3e-4, rtol=1e-3, err_msg=str(i))


# -- the roofline ----------------------------------------------------------------


def test_cell_params_at_v1_width_equal_the_scripts_constant():
    w = FX.width()
    net = w.options.net
    with torch.device("meta"):
        dec = Decoder(w.pose_in, w.pose_out, net.speech_encoder.speech_encoding_size,
                      net.style_encoder.style_encoding_size, net.decoder.nhidden)
    assert common.cell_weights(dec) == 18_910_208


def test_the_step_flops_follow_the_products_of_the_widths():
    """FLOPs (2 a multiply-add) of one --tiny step, derived from the widths:
    every product forward, then its weight gradient and its input gradient,
    except the input gradients of products whose input is data (the two
    encoders' first convolutions, and the pose part of the decoder's first
    step, whose pose is the batch's frame 0)."""
    step = Step("float32", torch.device("cpu"), tiny=True)
    w = FX.width(tiny=True)
    net = w.options.net
    B, T, Lx = step.batchsize, step.ds.window, step.ds.max_example_length
    P, O = w.pose_in, w.pose_out
    A_, Hs, S = FX.AUDIO_DIM, net.speech_encoder.nhidden, net.speech_encoder.speech_encoding_size
    Hst, Cs = net.style_encoder.nhidden, net.style_encoder.style_encoding_size
    E = 2 * Cs  # the VAE head's output: mu and logvar
    H = net.decoder.nhidden

    speech_first = B * T * A_ * Hs
    speech = speech_first + B * T * (Hs * S * 31 + S * S)
    style_first = B * Lx * P * Hst * 3
    style = (style_first + B * Lx * (Hst * E * 3 + E * 3 * E + E * E + 2 * E * E * 3)
             + 2 * B * Lx * Lx * E)
    cell = (P + S + Cs) * H + (H + P + S + Cs) * 3 * H + H * 3 * H + 2 * H * 3 * H + H * O
    cell_state = (P + Cs) * H + H * H + H * 2 * H
    decoder_first_pose = B * P * (H + 3 * H)
    macs = 3 * (speech + style + B * (T - 1) * cell + B * cell_state) - (
        speech_first + style_first + decoder_first_pose)
    assert common.cell_weights(step.nets["decoder"]) == cell
    flops = train_roofline.step_flops(step)
    assert flops == pytest.approx(2 * macs, rel=1e-2)


def test_the_bound_follows_the_documented_formula():
    cell, n, frames = 18_910_208, 23_000_000, 256
    for dtype, wbytes in (("float32", 4), ("bfloat16", 2)):
        got = train_roofline.analytic_bytes(cell, n, frames, dtype)
        assert got == frames * cell * wbytes * (1 + 1 + 2) + n * 4 * 8
    assert train_roofline.DW_ROUNDTRIPS == 2
    out = train_roofline.roofline("float32", torch.device("cpu"), tiny=True, measured_ms=2.0)
    assert out["bytes_accessed"] is None
    assert out["bound_ms"] == pytest.approx(
        max(out["flops"] / 67e12, out["analytic_bytes"] / 3.35e12) * 1e3)
    assert out["fraction_of_bound"] == pytest.approx(out["bound_ms"] / 2.0)


# -- the quickstart ----------------------------------------------------------------


def test_the_quickstart_runs_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(quickstart, "ITERATIONS", 3)
    out = quickstart.main([str(tmp_path / "qs"), "--device", "cpu"])
    anim = bvh.load(out["bvh"])
    assert anim["rotations"].shape[0] == out["frames"] == round(60 * 4.0)
    assert out["response"]["bvh"].startswith("HIERARCHY") and out["http_bvh_lines"] > 240
    printed = capsys.readouterr().out
    for step in range(1, 6):
        assert f"== {step}. " in printed
    assert "== done: HTTP response carried" in printed


# -- no fall-back to the CPU ----------------------------------------------------------


@pytest.mark.parametrize("entry,argv", [
    (C.main, ["--iters", "1"]),
    (A.main, ["--iters", "1"]),
    (loss_profile.main, []),
    (grad_profile.main, []),
    (train_step_profile.main, []),
    (fused_b1_profile.main, []),
    (train_roofline.main, []),
    (quickstart.main, []),
], ids=["train_curve", "train_anneal", "loss_profile", "grad_profile", "train_step_profile",
        "fused_b1_profile", "train_roofline", "quickstart"])
def test_the_default_device_is_the_card(entry, argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    args = ([str(tmp_path / "qs")] if entry is quickstart.main
            else ["--root", str(tmp_path / "run")] if entry in (C.main, A.main) else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry(argv + args)
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(SystemExit):
        loss_profile.main(["--tiny"])  # --tiny is a rehearsal on the CPU only
