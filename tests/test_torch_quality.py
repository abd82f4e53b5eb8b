"""The motion-quality evaluation of zeggs_tpu_torch
(`cli/eval_checkpoint.py`) against the JAX package's
`scripts/eval_checkpoint.py` on the CPU, and the quality gate both share.

One synthetic processed corpus (three 4 s clips through the port's data
pipeline; the last one validation, 180 frames) and narrow networks (decoder
H=32 with 2 GRU layers and the ``normal`` cell, speech 16/16, ``attn``
style body 24 wide with a 64-wide VAE embedding, the width the scripts'
default options read). Both evaluations run their own rollouts; the test
records them (a wrapper around JAX's ``decoder.rollout`` and the port's
``ProgramCache.rollout``, the rollout programs a float32 evaluation
replays) to measure how far the two rollouts lie apart, and derives the
tolerances of the statistics that amplify that difference from it.

Tolerances, per clip and for the aggregates:
* ``lpos_mae``, ``root_pos_mae`` and ``vel_ratio``: rtol 1e-3, with an
  atol of one rounding quantum of the report (1e-5 for the MAEs, 1e-4 for
  the ratios; the report rounds, and two values within rtol can round to
  neighbouring quanta).
* ``jerk_ratio``: the third difference times fps^3 amplifies a position
  difference of at most d per coordinate to at most 8 * 60^3 * sqrt(3) * d
  in a jerk magnitude, so the ratios differ by at most that over the
  ground truth's mean jerk, plus a quantum (two for an aggregate of
  rounded values).
* ``motion_var_ratio_median``: a variance over time moves by at most
  2 * std * d + d^2 when every frame moves by at most d, and a median by
  at most the largest move of its elements, so the bound is the largest
  of those moves over the moving joints, each over its ground-truth
  variance, plus a quantum (two for the aggregate).
* The gate verdicts are equal.

`tests/eval_agreement.py`'s `eval_bounds` and `reports_agree` implement
these bounds; tests/test_torch_cuda.py holds the evaluation on the card to
the CPU's with them.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import scripts.eval_checkpoint as jax_eval
from zeggs_tpu import config as JC
from zeggs_tpu.io import checkpoint as jax_checkpoint
from zeggs_tpu.models import decoder as jdec
from zeggs_tpu.train import loop as jloop
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.cli import eval_checkpoint as port_eval
from zeggs_tpu_torch.data.dataset import WindowedDataset
from zeggs_tpu_torch.data.pipeline import data_pipeline
from zeggs_tpu_torch.io import checkpoint, weights
from zeggs_tpu_torch.infer.programs import ProgramCache
from zeggs_tpu_torch.train import loop as tloop
from tests.eval_agreement import eval_bounds, reports_agree
from tests.synthetic import write_raw_corpus

OPTIONS = {"net_opt": {"decoder": {"nhidden": 32},
                       "speech_encoder": {"nhidden": 16, "speech_encoding_size": 16},
                       "style_encoder": {"nhidden": 24, "style_encoding_size": 64,
                                         "example_length": 32}},
           "train_opt": {"batchsize": 8, "window": 32, "learning_rate": 1e-3}}
# the shared short run: steps of the deterministic loss on corpus batches
TRAIN_STEPS, EXAMPLE_FRAMES = 10, 64


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The processed corpus and the networks' initial weights (JAX's
    initialisation, as numpy trees)."""
    root = tmp_path_factory.mktemp("quality")
    write_raw_corpus(root / "raw", n_clips=3, seconds=4.0)
    data_pipeline(TC.PipelineConfig(
        base_path=str(root / "raw"), processed_data_path="processed", info_filename="info.csv",
        audio_conf=TC.MelConfig(normalize_loudness=False), len_ratios=(1.0,),
        save_trimmed_audio=False, save_trimmed_animation=False), device="cpu")
    processed = root / "raw" / "processed"
    ds = WindowedDataset(processed / "data_definition.json", processed / "processed_data.npz",
                         OPTIONS["train_opt"]["window"],
                         example_length=OPTIONS["net_opt"]["style_encoder"]["example_length"])
    jopts = JC.Options.from_options_dict(OPTIONS)
    params = jax.tree.map(np.asarray, jloop.init_networks(jax.random.PRNGKey(0), jopts,
                                                          ds.get_shapes(), ds.nlabels))
    return dict(root=root, processed=processed, ds=ds, params=params)


def _run_root(c, name, iteration, trees, save):
    """A run root: the corpus's processed/ and models/<iteration>/ holding
    ``trees`` written by ``save`` (either package's checkpoint.save)."""
    root = c["root"] / name
    (root / "models" / str(iteration)).mkdir(parents=True)
    (root / "processed").symlink_to(c["processed"])
    for n, tree in trees.items():
        save(root / "models" / str(iteration) / f"{n}.npz", tree)
    return root


def record_rollouts(monkeypatch):
    """From now on in the test, each package's decoder rollouts, as
    (root_pos, lpos) numpy arrays of one clip."""
    rec = {"jax": [], "port": []}
    jax_rollout, port_rollout = jdec.rollout, ProgramCache.rollout

    def jax_recording(*args, **kw):
        out = jax_rollout(*args, **kw)
        rec["jax"].append((np.asarray(out[0][0]), np.asarray(out[4][0])))
        return out

    def port_recording(*args, **kw):
        out = port_rollout(*args, **kw)  # root_pos, root_rot, lpos, ltxy
        rec["port"].append((out[0][0].float().cpu().numpy(), out[2][0].float().cpu().numpy()))
        return out

    monkeypatch.setattr(jdec, "rollout", jax_recording)
    monkeypatch.setattr(ProgramCache, "rollout", port_recording)
    return rec


def assert_reports_agree(ds, ours, ref, rec, node):
    """The port's report against the JAX script's, within the tolerances of
    the module docstring (`tests/eval_agreement.py::reports_agree`, which
    the card's evaluation is held to as well); the readings go to the test
    ``node``'s properties (the ``--junitxml`` report). Returns the per-clip
    (d, jerk bound, variance bound)."""
    assert len(rec["port"]) == len(rec["jax"]) == ref["n_valid_clips"] == ours["n_valid_clips"]
    bounds = eval_bounds(ds, rec["port"], rec["jax"])
    for name, i in (("max_lpos_diff", 0), ("jerk_ratio_bound", 1), ("var_ratio_bound", 2)):
        node.user_properties.append((name, max(b[i] for b in bounds)))
    for k in ("lpos_mae_mean", "vel_ratio_mean", "jerk_ratio_mean", "motion_var_ratio_median"):
        node.user_properties.append((k, [ours[k], ref[k]]))
    assert reports_agree(ours, ref, bounds) == []
    assert ours["iteration"] == ref["iteration"]
    assert port_eval.gate(ours) == port_eval.gate(ref)
    return bounds


def test_evaluate_matches_the_jax_script(corpus, monkeypatch, request):
    c = corpus
    recorded = record_rollouts(monkeypatch)
    root = _run_root(c, "initial", 0, c["params"], checkpoint.save)
    ours = port_eval.evaluate(root, 0, device="cpu")
    ref = jax_eval.evaluate(root, 0)
    bounds = assert_reports_agree(c["ds"], ours, ref, recorded, request.node)
    assert ours["n_valid_clips"] == 1 and ours["total_frames"] == 180
    # the rollouts are close enough for the derived bounds to mean something
    assert all(d < 1e-4 for d, _, _ in bounds)


def _jax_step(jopts, ds, params, batch):
    """JAX's deterministic loss, its gradients and a RAdam update, compiled
    once at the backend's lowest optimisation level."""
    loss_fn = jloop.make_loss_fn(jopts, ds.stats, ds.parents, ds.dt, deterministic=True)
    tx = jloop.make_optimizer(jopts)
    key = jax.random.PRNGKey(9)

    def step(p, state, b, it):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p, b, it, key)
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state, loss

    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    args = (p, state, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.float32(0))
    compiled = jax.jit(step).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return compiled, p, state


def test_a_shared_short_run_passes_the_same_gate(corpus, monkeypatch, request):
    """Both packages train TRAIN_STEPS deterministic steps from the same
    initial weights on the same corpus batches; each evaluates its own
    checkpoint, and the reports agree. Neither run passes the gate at this
    depth (collapsed: velocity ratio about 0.04 against the gate's 0.5),
    so the verdicts are compared, not asserted true."""
    c = corpus
    ds = c["ds"]
    jopts, topts = (cls.Options.from_options_dict(OPTIONS) for cls in (JC, TC))
    rng = np.random.default_rng(0)
    B = OPTIONS["train_opt"]["batchsize"]
    batches = [ds.make_batch(rng.permutation(len(ds))[:B], example_window_length=EXAMPLE_FRAMES)
               for _ in range(TRAIN_STEPS)]
    jstep, pj, state = _jax_step(jopts, ds, c["params"], batches[0])
    nets = tloop.init_networks(topts, ds.get_shapes(), ds.nlabels, 0, device="cpu")
    for name, module in nets.items():
        module.load_state_dict(weights.from_jax(c["params"][name]), strict=True)
    _, step = tloop.make_train_step(topts, ds.stats, ds.parents, ds.dt, nets, deterministic=True)
    for i, b in enumerate(batches):
        pj, state, jloss = jstep(pj, state, {k: jnp.asarray(v) for k, v in b.items()},
                                 jnp.float32(i))
        metrics = step({k: torch.as_tensor(v) for k, v in b.items()}, i)
        np.testing.assert_allclose(metrics["total_loss"].item(), float(jloss), rtol=1e-4)

    port_root = _run_root(c, "port_run", TRAIN_STEPS,
                          {n: weights.to_jax(m) for n, m in nets.items()}, checkpoint.save)
    jax_root = _run_root(c, "jax_run", TRAIN_STEPS, jax.tree.map(np.asarray, pj),
                         jax_checkpoint.save)
    recorded = record_rollouts(monkeypatch)
    ours = port_eval.evaluate(port_root, TRAIN_STEPS, device="cpu")
    ref = jax_eval.evaluate(jax_root, TRAIN_STEPS)
    assert_reports_agree(ds, ours, ref, recorded, request.node)
    assert not port_eval.gate(ref)


def test_label_runs_are_refused_and_failing_gates_exit_1(corpus, tmp_path, capsys):
    c = corpus
    root = _run_root(c, "gate", 0, c["params"], checkpoint.save)
    argv = ["--root", str(root), "--iteration", "0"]
    assert jax_eval.main(argv + ["--out", str(tmp_path / "jax.json"), "--cpu"]) == 1
    assert port_eval.main(argv + ["--out", str(tmp_path / "port.json"), "--device", "cpu"]) == 1
    verdicts = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                if line.startswith("{")]
    assert [v["not_collapsed_not_jittery"] for v in verdicts] == [False, False]
    ours, ref = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("port", "jax"))
    assert ours.keys() == ref.keys() and ours["clips"][0].keys() == ref["clips"][0].keys()

    # a label-style run: a speech encoder and a decoder whose style input
    # is the one-hot label, no style encoder
    ds = c["ds"]
    label_opts = JC.Options.from_options_dict(
        {**OPTIONS, "train_opt": {**OPTIONS["train_opt"], "style_encoding_type": "label"}})
    trees = jloop.init_networks(jax.random.PRNGKey(1), label_opts, ds.get_shapes(), ds.nlabels)
    assert sorted(trees) == ["decoder", "speech_encoder"]
    label = _run_root(c, "label_run", 0, trees, checkpoint.save)
    with pytest.raises(FileNotFoundError):
        jax_eval.evaluate(label, 0)
    with pytest.raises(ValueError, match="label-style run"):
        port_eval.evaluate(label, 0, device="cpu")


def test_evaluate_defaults_to_the_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = _run_root(corpus, "card", 0, corpus["params"], checkpoint.save)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.main(["--root", str(root), "--iteration", "0", "--out", str(tmp_path / "x")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_eval.evaluate(root, 0)


def test_the_gate_reads_the_scripts_bounds():
    base = dict(vel_ratio_mean=1.0, jerk_ratio_mean=1.0, motion_var_ratio_median=1.0)
    assert port_eval.gate(base)
    for key, value in (("vel_ratio_mean", 0.49), ("vel_ratio_mean", 2.51),
                       ("jerk_ratio_mean", 10.01), ("motion_var_ratio_median", 0.24)):
        assert not port_eval.gate({**base, key: value}), key
    for key, value in (("vel_ratio_mean", 0.5), ("vel_ratio_mean", 2.5),
                       ("jerk_ratio_mean", 10.0), ("motion_var_ratio_median", 0.25)):
        assert port_eval.gate({**base, key: value}), key
