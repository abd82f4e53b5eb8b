"""The port's train program (`train/programs.py::TrainProgram`) on the CPU,
where its body runs eagerly, and the training-time rollouts on the rollout
programs (`infer/programs.py::ProgramCache`).

* Three deterministic steps of the program, the batch gathered from a
  `DeviceCorpus` at the static example width (Lmax, masked past each
  row's length), against `zeggs_tpu`'s device train step: its
  `DeviceCorpus.gather_batch`, `make_loss_fn(deterministic=True)` and
  `make_optimizer`; example and label styles. Parameters within 1e-5 of
  max(1, max|p|) per leaf (`test_three_train_steps_match_jax`'s bound).
* The same three steps against the plain `make_train_step` on the
  examples cut to their drawn width: the mask keeps the values. Bound:
  losses rtol 1e-6, parameters 1e-6 of max(1, max|p|) per leaf (float32
  sums over more masked terms, in another order).
* RAdam's update from scalars in a device tensor (as the program reads
  them) against JAX's `radam` over 30 steps, both branches and an lr
  halving: 1e-6, as `test_radam_and_schedule_match_jax`.
* The KL weight from a float32 tensor iteration against JAX: rtol 1e-6.
* Two `Trainer.run` segments with a resume between them equal one run
  exactly, with host batches and with label styles.
* `Trainer.generate_samples` and `cli.eval_checkpoint.evaluate` through the
  programs equal the eager rollout exactly (BVH text, report).
* `dataset_stats_table` writes `zeggs_tpu`'s text.

Small widths: 8 joints, decoder H=32, windows of 16 frames, examples of
24-48 frames (Lmax 48), B=3 (the trainers B=32); a corpus of three 4 s
clips through the port's pipeline.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from zeggs_tpu import config as JC
from zeggs_tpu.data.dataset import WindowedDataset as JaxDataset
from zeggs_tpu.data.dataset import dataset_stats_table as jax_stats_table
from zeggs_tpu.data.device_dataset import DeviceCorpus as JaxCorpus
from zeggs_tpu.train import loop as jloop
from zeggs_tpu.train import loss as jloss
from zeggs_tpu.train import radam as jradam
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.cli import eval_checkpoint as E
from zeggs_tpu_torch.data.dataset import WindowedDataset, dataset_stats_table
from zeggs_tpu_torch.data.device_dataset import DeviceCorpus
from zeggs_tpu_torch.data.pipeline import data_pipeline
from zeggs_tpu_torch.io import checkpoint, weights
from zeggs_tpu_torch.models import decoder as D
from zeggs_tpu_torch.train import loop as tloop
from zeggs_tpu_torch.train import loss as tloss
from zeggs_tpu_torch.train import radam as tradam
from zeggs_tpu_torch.train.programs import TrainProgram
from tests.synthetic import small_options, write_raw_corpus

B, WINDOW, EXAMPLE = 3, 16, 24
STEPS = 3
RUN_BATCH = 32  # the trainers' batch: a few steps an epoch


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_programs")
    write_raw_corpus(root, n_clips=3, seconds=4.0)
    data_pipeline(TC.PipelineConfig(
        base_path=str(root), processed_data_path="processed", info_filename="info.csv",
        audio_conf=TC.MelConfig(normalize_loudness=False), len_ratios=(1.0,),
        save_trimmed_audio=False, save_trimmed_animation=False), device="cpu")
    return root


def _options_dict(style="example", **train):
    od = small_options().to_options_dict()
    od["net_opt"]["style_encoder"]["example_length"] = EXAMPLE
    od["train_opt"] = dict(batchsize=B, window=WINDOW, style_encoding_type=style,
                           learning_rate=1e-3, **train)
    return od


def _datasets(corpus, style):
    p = corpus / "processed"
    args = (p / "data_definition.json", p / "processed_data.npz", WINDOW)
    kw = dict(style_encoding_type=style, example_length=EXAMPLE)
    return WindowedDataset(*args, **kw), JaxDataset(*args, **kw)


def _networks(jopts, topts, ds, seed=1):
    params = jloop.init_networks(jax.random.PRNGKey(seed), jopts, ds.get_shapes(), ds.nlabels)
    nets = tloop.init_networks(topts, ds.get_shapes(), ds.nlabels, seed, device="cpu")
    for name, module in nets.items():
        module.load_state_dict(weights.from_jax(params[name]), strict=True)
    return jax.tree.map(jnp.asarray, params), nets


def _draws(ds, style, seed=3):
    """STEPS batches of window indices and example lengths (None: labels)."""
    rng = np.random.default_rng(seed)
    return [(rng.permutation(len(ds))[:B],
             None if style == "label" else ds.sample_example_length(rng)) for _ in range(STEPS)]


def _inputs(ds, corpus, idx, ewl):
    if ewl is None:
        return {"window_starts": ds.window_starts[idx], "labels": ds.window_labels[idx]}
    starts, ex_idx, ex_len = corpus.sample_indices(idx, ewl)
    return {"window_starts": starts, "ex_idx": ex_idx, "ex_lengths": ex_len}


def _program(topts, ds, nets, deterministic=True):
    optimizer = tloop.make_optimizer(topts, nets)
    loss_fn = tloop.make_loss_fn(topts, ds.stats, ds.parents, ds.dt, deterministic)
    corpus = DeviceCorpus(ds, device="cpu")
    return TrainProgram(loss_fn, nets, optimizer, corpus=corpus, nlabels=ds.nlabels), corpus


def _assert_close(ours, ref, scale_tol):
    """Per leaf max|diff| <= scale_tol * max(1, max|ref|)."""
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(ref))
    flat_ours = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert flat_ours.keys() == flat_ref.keys()
    for path, leaf in flat_ref.items():
        leaf = np.asarray(leaf)
        tol = scale_tol * max(1.0, float(np.abs(leaf).max()))
        err = float(np.abs(np.asarray(flat_ours[path]) - leaf).max())
        assert err <= tol, (jax.tree_util.keystr(path), err, tol)


@pytest.mark.parametrize("style", ["example", "label"])
def test_three_program_steps_match_the_jax_device_step(corpus, style):
    od = _options_dict(style)
    jopts, topts = JC.Options.from_options_dict(od), TC.Options.from_options_dict(od)
    ds, jds = _datasets(corpus, style)
    pj, nets = _networks(jopts, topts, ds)
    program, tcorpus = _program(topts, ds, nets)
    jcorpus = JaxCorpus(jds)
    jfn = jloop.make_loss_fn(jopts, jds.stats, jds.parents, jds.dt, deterministic=True)
    tx = jloop.make_optimizer(jopts)
    state = tx.init(pj)
    draws = _draws(ds, style)

    def jbatch(idx, ewl):
        if ewl is None:
            return jcorpus.gather_batch(jnp.asarray(jds.window_starts[idx]),
                                        labels=jnp.asarray(jds.window_labels[idx]),
                                        nlabels=jds.nlabels)
        return jcorpus.gather_batch(*(jnp.asarray(a) for a in jcorpus.sample_indices(idx, ewl)))

    args = (pj, jbatch(*draws[0]), jnp.float32(0), jax.random.PRNGKey(0))
    grad = jax.jit(jax.value_and_grad(jfn, has_aux=True)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    update = jax.jit(tx.update)
    for i, (idx, ewl) in enumerate(draws):
        (jl, _), g = grad(pj, jbatch(idx, ewl), jnp.float32(i), args[3])
        updates, state = update(g, state, pj)
        pj = optax.apply_updates(pj, updates)
        metrics = program.run(_inputs(ds, tcorpus, idx, ewl), i)
        np.testing.assert_allclose(metrics["total_loss"].item(), float(jl), rtol=1e-5)
    assert program.optimizer.step_count == STEPS == int(state.step)
    _assert_close({n: weights.to_jax(m) for n, m in nets.items()}, pj, 1e-5)


def test_program_equals_the_plain_step_on_cut_examples(corpus):
    """The program's Lmax-wide masked examples against the plain step on
    the same examples cut to their drawn width, which the port's trainer
    ran before its examples were static."""
    topts = TC.Options.from_options_dict(_options_dict())
    ds, _ = _datasets(corpus, "example")
    nets = tloop.init_networks(topts, ds.get_shapes(), ds.nlabels, 2, device="cpu")
    plain_nets = tloop.init_networks(topts, ds.get_shapes(), ds.nlabels, 2, device="cpu")
    program, tcorpus = _program(topts, ds, nets)
    _, plain = tloop.make_train_step(topts, ds.stats, ds.parents, ds.dt, plain_nets,
                                     deterministic=True)
    draws = _draws(ds, "example", seed=4)
    assert len({ewl for _, ewl in draws} - {ds.max_example_length}) > 0  # some cut
    for i, (idx, ewl) in enumerate(draws):
        inputs = _inputs(ds, tcorpus, idx, ewl)
        metrics = program.run(inputs, i)
        ref = plain(tcorpus.gather_batch(inputs["window_starts"], inputs["ex_idx"][:, :ewl],
                                         inputs["ex_lengths"]), i)
        np.testing.assert_allclose(metrics["total_loss"].item(), ref["total_loss"].item(),
                                   rtol=1e-6)
    _assert_close({n: weights.to_jax(m) for n, m in nets.items()},
                  {n: weights.to_jax(m) for n, m in plain_nets.items()}, 1e-6)


def test_radam_from_device_scalars_matches_jax():
    """The program's update: RAdam's scalars written into one tensor each
    step, `RAdam.apply` reading them; 30 steps on a quadratic with the lr
    halving every 10 steps, the SGD branch (steps 1-5) then the rectified
    one."""
    w0 = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    target = np.ones((5, 3), np.float32)
    tx = jradam.radam(jradam.exponential_step_schedule(1e-2, 0.5, every=10), eps=1e-5)
    pj = {"w": jnp.asarray(w0)}
    state = tx.init(pj)
    wt = torch.as_tensor(w0.copy())
    opt = tradam.RAdam({"w": wt}, tradam.exponential_step_schedule(1e-2, 0.5, every=10),
                       eps=1e-5)
    buf = torch.zeros(3)
    branches = []
    for _ in range(30):
        g = jax.grad(lambda p: jnp.sum((p["w"] - target) ** 2 * jnp.arange(1.0, 4.0)))(pj)
        updates, state = tx.update(g, state, pj)
        pj = optax.apply_updates(pj, updates)
        scalars = opt.scalars()
        branches.append("sgd" if scalars[0] == 0 else "rectified")
        buf.copy_(torch.from_numpy(scalars))
        opt.apply(buf, {"w": torch.as_tensor(np.array(g["w"]))})
        opt.step_count += 1
        np.testing.assert_allclose(wt.numpy(), np.asarray(pj["w"]), atol=1e-6, rtol=0)
    assert branches == ["sgd"] * 5 + ["rectified"] * 25
    assert opt.step_count == int(state.step) == 30
    np.testing.assert_allclose(opt.exp_avg["w"].numpy(), np.asarray(state.exp_avg["w"]),
                               atol=1e-6)
    np.testing.assert_allclose(opt.exp_avg_sq["w"].numpy(), np.asarray(state.exp_avg_sq["w"]),
                               atol=1e-6)


@pytest.mark.parametrize("iteration", [0, 7500, 20000])
def test_kl_weight_from_a_tensor_iteration_matches_jax(iteration):
    rng = np.random.default_rng(iteration + 1)
    mu, logvar = (rng.normal(size=(4, 8)).astype(np.float32) for _ in range(2))
    kl_j, w_j = jloss.kl_divergence(jnp.asarray(mu), jnp.asarray(logvar), iteration)
    kl_t, w_t = tloss.kl_divergence(torch.as_tensor(mu), torch.as_tensor(logvar),
                                    torch.tensor(float(iteration), dtype=torch.float32))
    np.testing.assert_allclose(kl_t.numpy(), np.asarray(kl_j), rtol=1e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-6, atol=0)
    _, w_float = tloss.kl_divergence(torch.as_tensor(mu), torch.as_tensor(logvar), iteration)
    assert torch.equal(w_t, w_float)


def _trainer(corpus, models, style, device_corpus, resume=False):
    od = _options_dict(style, niterations=1, seed=5, resume=resume, generate_samples_step=10_000,
                       use_tensorboard=False)
    od["train_opt"]["batchsize"] = RUN_BATCH
    p = corpus / "processed"
    return tloop.Trainer(TC.Options.from_options_dict(od), models, models.parent / "logs",
                         p / "processed_data.npz", p / "data_definition.json",
                         device_corpus=device_corpus, device="cpu")


def _params(trainer):
    return {k: p.detach().clone() for k, p in trainer.optimizer.params.items()}


@pytest.mark.parametrize("style,device_corpus", [("example", False), ("label", True)])
def test_resumed_run_equals_one_run(corpus, tmp_path, style, device_corpus):
    """An epoch, a checkpoint, a new trainer resumed from it for a second
    epoch: equal to two epochs of one trainer, parameters, moments and
    generator bit for bit."""
    first = _trainer(corpus, tmp_path / "a" / "models", style, device_corpus)
    bpe = len(first.ds) // RUN_BATCH
    assert bpe >= 2
    first.run(max_iterations=bpe)
    first.save_checkpoint()
    resumed = _trainer(corpus, tmp_path / "a" / "models", style, device_corpus, resume=True)
    assert resumed.iteration == bpe and resumed.program.steps == 0
    resumed.run(max_iterations=2 * bpe)
    whole = _trainer(corpus, tmp_path / "b" / "models", style, device_corpus)
    whole.run(max_iterations=2 * bpe)
    assert resumed.optimizer.step_count == whole.optimizer.step_count == 2 * bpe
    assert torch.equal(resumed.generator.get_state(), whole.generator.get_state())
    for k, v in _params(whole).items():
        assert torch.equal(_params(resumed)[k], v), k
        assert torch.equal(resumed.optimizer.exp_avg_sq[k], whole.optimizer.exp_avg_sq[k]), k


class EagerRollouts:
    """`ProgramCache`'s rollout through the eager `decoder.rollout`."""

    def __init__(self, dec, stats, dt):
        self.dec, self.dt = dec, dt
        self.stats = tuple(stats[k] for k in ("anim_input_mean", "anim_input_std",
                                              "anim_output_mean", "anim_output_std"))

    def rollout(self, state0, gaze, speech, style):
        return D.rollout(self.dec, *state0, gaze, speech, style, *self.stats, self.dt,
                         output_indices=(0, 1, 4, 5))

    def programs(self):
        return []


def test_sample_synthesis_on_programs_equals_the_eager_rollout(corpus, tmp_path, monkeypatch):
    trainer = _trainer(corpus, tmp_path / "models", "example", True)
    steps, programs = trainer.generate_samples(1, 2)
    graphed = {p.name: p.read_text() for p in trainer.samples_dir.glob("*.bvh")}
    assert steps > 0 and programs > 0 and len(graphed) == 4
    trainer.samples_dir = tmp_path / "eager"
    trainer.samples_dir.mkdir()
    monkeypatch.setattr(tloop, "ProgramCache", EagerRollouts)
    assert trainer.generate_samples(1, 2) == (steps, 0)
    eager = {p.name: p.read_text() for p in trainer.samples_dir.glob("*.bvh")}
    assert eager == graphed


def test_evaluation_on_programs_equals_the_eager_rollout(corpus, tmp_path, monkeypatch):
    od = _options_dict()
    od["net_opt"]["style_encoder"]["style_encoding_size"] = 64  # what Options() reads
    topts = TC.Options.from_options_dict(od)
    ds, _ = _datasets(corpus, "example")
    nets = tloop.init_networks(topts, ds.get_shapes(), ds.nlabels, 3, device="cpu")
    root = tmp_path / "run"
    (root / "models").mkdir(parents=True)
    (root / "processed").symlink_to(corpus / "processed")
    checkpoint.save_train_state(root / "models" / "0", 0,
                                {n: weights.to_jax(m) for n, m in nets.items()})
    graphed = E.evaluate(root, 0, device="cpu")
    monkeypatch.setattr(E, "ProgramCache", EagerRollouts)
    assert E.evaluate(root, 0, device="cpu") == graphed
    assert graphed["n_valid_clips"] == 1


def test_dataset_stats_table_matches_jax(corpus):
    class Fake:  # tests/test_aux.py's fake dataset
        label_names = ["A", "B"]
        ranges_train = np.array([[0, 120], [120, 300]])
        ranges_train_labels = np.array([0, 1])
        ranges_valid = np.array([[300, 360]])
        ranges_valid_labels = np.array([0])

    assert dataset_stats_table(Fake()) == jax_stats_table(Fake())
    ds, jds = _datasets(corpus, "example")
    text = dataset_stats_table(ds)
    assert text == jax_stats_table(jds)
    assert text.startswith("Data Info") and "TOTAL" in text and len(ds.label_names) > 1


def test_program_inputs_are_static(corpus):
    topts = TC.Options.from_options_dict(_options_dict())
    ds, _ = _datasets(corpus, "example")
    nets = tloop.init_networks(topts, ds.get_shapes(), ds.nlabels, 2, device="cpu")
    program, tcorpus = _program(topts, ds, nets)
    idx, ewl = _draws(ds, "example")[0]
    inputs = _inputs(ds, tcorpus, idx, ewl)
    program.run(inputs, 0)
    with pytest.raises(ValueError, match="static at"):
        program.run({**inputs, "ex_idx": inputs["ex_idx"][:, :ewl]}, 1)
    with pytest.raises(ValueError, match="inputs are"):
        program.run({"window_starts": inputs["window_starts"]}, 1)
    assert program.steps == program.optimizer.step_count == 1
