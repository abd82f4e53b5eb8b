"""The port's `Trainer` and training CLI on the CPU: a run, its checkpoint and
a lossless resume (iteration, epoch, data-order RNG and dropout generator
continue, and the resumed run's parameters equal an uninterrupted run's
exactly, as tests/test_train.py holds the JAX trainer to); checkpoints
readable in both directions (zeggs_tpu reads the port's, the port resumes
one that zeggs_tpu's Trainer writes); finite sample BVHs; the CLI with and
without host batches."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zeggs_tpu import config as JC
from zeggs_tpu.io import checkpoint as jax_checkpoint
from zeggs_tpu.train.loop import Trainer as JaxTrainer
from zeggs_tpu.train.radam import RAdamState
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.cli import train as cli
from zeggs_tpu_torch.data.pipeline import data_pipeline
from zeggs_tpu_torch.io import bvh, weights
from zeggs_tpu_torch.train.loop import Trainer, init_networks
from tests.synthetic import small_options, write_raw_corpus

BATCH, WINDOW = 8, 32


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_corpus")
    write_raw_corpus(root, n_clips=3, seconds=2.5)
    data_pipeline(TC.PipelineConfig(
        base_path=str(root), processed_data_path="processed", info_filename="info.csv",
        audio_conf=TC.MelConfig(normalize_loudness=False), len_ratios=(1.0,),
        save_trimmed_audio=False, save_trimmed_animation=False), device="cpu")
    p = root / "processed"
    return dict(root=root, data=p / "processed_data.npz", definition=p / "data_definition.json")


def _options(gss, resume=False):
    od = small_options().to_options_dict()
    od["train_opt"] = dict(batchsize=BATCH, window=WINDOW, niterations=1, resume=resume, seed=77,
                           generate_samples_step=gss, use_tensorboard=False)
    return TC.Options.from_options_dict(od)


def _trainer(c, models, gss, resume=False):
    return Trainer(_options(gss, resume), models, models.parent / f"{models.name}_logs",
                   c["data"], c["definition"], device="cpu")


def _params(trainer):
    return {f"{n}.{k}": p.detach().clone() for n, m in trainer.nets.items()
            for k, p in m.named_parameters()}


def test_run_checkpoint_resume_is_lossless(corpus, tmp_path):
    c = corpus
    probe = _trainer(c, tmp_path / "probe", 1)
    bpe = len(probe.ds) // BATCH  # batches an epoch
    assert bpe >= 2

    t1 = _trainer(c, tmp_path / "m_resume", bpe)
    t1.run(max_iterations=bpe)
    t1.save_checkpoint()
    assert (t1.iteration, t1.epoch) == (bpe, 1)
    samples = sorted((tmp_path / "m_resume_logs" / "samples").glob("iteration_0_*.bvh"))
    assert {p.name.split("_")[3] for p in samples} == {"ground", "predict"}
    for p in samples:
        anim = bvh.load(p)
        assert np.isfinite(anim["positions"]).all() and np.isfinite(anim["rotations"]).all()

    t2 = _trainer(c, tmp_path / "m_resume", bpe, resume=True)
    assert (t2.iteration, t2.epoch) == (t1.iteration, t1.epoch)
    assert t2.rng.bit_generator.state == t1.rng.bit_generator.state
    assert torch.equal(t2.generator.get_state(), t1.generator.get_state())
    assert t2.optimizer.step_count == t1.optimizer.step_count == bpe
    for k, v in _params(t1).items():
        assert torch.equal(_params(t2)[k], v), k
    t2.run(max_iterations=2 * bpe)
    assert (t2.iteration, t2.epoch) == (2 * bpe, 2)

    t3 = _trainer(c, tmp_path / "m_full", bpe)
    t3.run(max_iterations=2 * bpe)
    full = _params(t3)
    for k, v in _params(t2).items():
        assert torch.equal(v, full[k]), k


def test_jax_reads_the_port_checkpoint(corpus, tmp_path):
    t = _trainer(corpus, tmp_path / "m", 100)
    t.run(max_iterations=3)
    t.save_checkpoint()
    nets, opt_state, meta = jax_checkpoint.load_train_state(tmp_path / "m")
    assert meta["step"] == 3 and set(nets) == set(t.nets)
    for name, module in t.nets.items():
        for k, v in weights.from_jax(nets[name]).items():
            assert torch.equal(v, module.state_dict()[k]), (name, k)
    step, exp_avg, exp_avg_sq = weights.opt_state_from_jax(opt_state)
    assert step == t.optimizer.step_count == 3
    for name in t.nets:
        for k, v in exp_avg[name].items():
            assert torch.equal(v, t.optimizer.exp_avg[f"{name}.{k}"])
            assert torch.equal(exp_avg_sq[name][k], t.optimizer.exp_avg_sq[f"{name}.{k}"])
    # the tree is the JAX package's RAdamState, leaf for leaf
    template = jax.tree.map(np.asarray, RAdamState(jnp.zeros([], jnp.int32), nets, nets))
    assert len(jax.tree.leaves(template)) == len(jax.tree.leaves(opt_state))


def test_port_resumes_a_jax_trainer_checkpoint(corpus, tmp_path):
    """zeggs_tpu's Trainer writes the checkpoint (its save_checkpoint, after
    its loop state and optimizer moments were moved on); the port resumes
    every piece of it."""
    c = corpus
    od = _options(100).to_options_dict()
    jt = JaxTrainer(JC.Options.from_options_dict(od), tmp_path / "m", tmp_path / "logs",
                    c["data"], c["definition"])
    jt.iteration, jt.epoch = 5, 1
    jt.rng.permutation(10)
    jt.opt_state = RAdamState(jnp.asarray(5, jnp.int32),
                              jax.tree.map(lambda p: p * 0.01, jt.params),
                              jax.tree.map(lambda p: p * p, jt.params))
    jt.save_checkpoint()

    t = _trainer(c, tmp_path / "m", 100, resume=True)
    assert (t.iteration, t.epoch, t.optimizer.step_count) == (5, 1, 5)
    assert t.rng.bit_generator.state == jt.rng.bit_generator.state
    for name, module in t.nets.items():
        ref = weights.from_jax(jax.tree.map(np.asarray, jt.params[name]))
        for k, v in module.state_dict().items():
            assert torch.equal(v, ref[k]), (name, k)
            assert torch.equal(t.optimizer.exp_avg[f"{name}.{k}"], ref[k] * 0.01)
    t.run(max_iterations=6)
    assert t.iteration == 6


@pytest.mark.parametrize("host_batches", [False, True])
def test_cli_trains_on_the_cpu(corpus, tmp_path, host_batches):
    od = _options(100).to_options_dict()
    od["paths"] = {"base_path": str(corpus["root"]), "path_processed_data": "processed",
                   "output_dir": str(tmp_path / "out"), "models_dir": None}
    (tmp_path / "options.json").write_text(json.dumps(od))
    argv = ["-o", str(tmp_path / "options.json"), "--device", "cpu", "--max-iterations", "2"]
    trainer = cli.main(argv + (["--host-batches"] if host_batches else []))
    assert trainer.iteration == 2 and (trainer.device_corpus is None) == host_batches
    meta = json.loads((tmp_path / "out" / "saved_models" / "checkpoint.json").read_text())
    assert meta["step"] == 2
    written = json.loads((tmp_path / "out" / "options.json").read_text())
    assert written["provenance"]["device"] == "cpu" and "torch" in written["provenance"]
    log = (tmp_path / "out" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(log[0])["step"] == 0 and np.isfinite(json.loads(log[0])["total_loss"])


@pytest.mark.parametrize("option", ["remat", "bfloat16"])
def test_remat_and_compute_dtype(corpus, tmp_path, option):
    """remat recomputes each decoder step in the backward pass and changes no
    gradient. The Trainer passes compute_dtype on: bfloat16 products change
    the loss, by 4.4e-4 of the float32 loss on the CPU (bound 2e-3), and keep
    every gradient finite; their parity with zeggs_tpu's bfloat16 run is
    tests/test_torch_train_grads.py::test_bfloat16_gradients_match_jax_grad."""
    base = _options(100)
    train = (dict(remat=True) if option == "remat" else dict(compute_dtype="bfloat16"))
    other = dataclasses.replace(base, train=dataclasses.replace(base.train, **train))
    grads, losses = [], []
    for opts in (base, other):
        t = Trainer(opts, tmp_path / option, tmp_path / "logs", corpus["data"],
                    corpus["definition"], device="cpu")
        metrics = t.train_step(t._batch(np.arange(BATCH), 96))
        losses.append(metrics["total_loss"].item())
        grads.append({k: p.grad.clone() for k, p in t.optimizer.params.items()})
    for k, g in grads[0].items():
        assert torch.isfinite(grads[1][k]).all(), k
        if option == "remat":
            torch.testing.assert_close(grads[1][k], g, rtol=1e-5, atol=1e-6)
    if option == "remat":
        assert losses[1] == pytest.approx(losses[0], rel=1e-6)
    else:
        assert losses[1] != losses[0] and losses[1] == pytest.approx(losses[0], rel=2e-3)


def test_trainer_needs_its_device(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_options(100), tmp_path / "m", tmp_path / "l", corpus["data"],
                corpus["definition"])


def test_init_networks_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    dims = dict(num_audio_features=81, pose_input_size=30, pose_output_size=27)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_networks(_options(100), dims, 3, 0)


def test_options_dataclasses_match(corpus):
    """The options the CLI writes read back to the same values."""
    opts = _options(7)
    assert TC.Options.from_options_dict(opts.to_options_dict()) == opts
    assert dataclasses.asdict(opts.train)["generate_samples_step"] == 7
