"""Multi-process training of the port on the CPU: two processes of a gloo
group, each the training CLI with --coordinator-address, --num-processes
and --process-id, against one process at the same seed (the contract of
zeggs_tpu's multi-host Trainer, tests/test_multihost.py).

After 3 iterations the two-process parameters equal the one-process run's
within rtol 2e-5 / atol 1e-6 (the JAX test's bound: the gradient average
sums in another order), on both data paths (host batches and the device
corpus), and with the group joined from torchrun's environment variables
instead of the flags; a two-process run restarted at an epoch boundary equals an
uninterrupted one-process run; only rank 0 writes; a batch size that does
not divide by the process count raises. Every spawned process runs one
torch thread and is waited for with a timeout.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.cli import train as cli
from zeggs_tpu_torch.data.dataset import WindowedDataset
from zeggs_tpu_torch.data.pipeline import data_pipeline
from zeggs_tpu_torch.io import checkpoint
from zeggs_tpu_torch.parallel import distributed
from zeggs_tpu_torch.train.loop import Trainer
from tests.synthetic import small_options, write_raw_corpus

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).parent / "torch_ddp_worker.py"
BATCH, WINDOW, N_ITER = 8, 32, 3
TIMEOUT_S = 180


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_corpus")
    # one training clip of 60 frames (28 windows, 3 batches an epoch) and
    # one validation clip
    write_raw_corpus(root, n_clips=2, seconds=2.5)
    data_pipeline(TC.PipelineConfig(
        base_path=str(root), processed_data_path="processed", info_filename="info.csv",
        audio_conf=TC.MelConfig(normalize_loudness=False), len_ratios=(1.0,),
        save_trimmed_audio=False, save_trimmed_animation=False), device="cpu")
    return root


def _options(corpus, path, output_dir, resume=False, batchsize=BATCH):
    od = small_options().to_options_dict()
    od["train_opt"] = dict(batchsize=batchsize, window=WINDOW, niterations=1, seed=77,
                           resume=resume, generate_samples_step=10_000, use_tensorboard=False)
    od["paths"] = {"base_path": str(corpus), "path_processed_data": "processed",
                   "output_dir": str(output_dir), "models_dir": None}
    path.write_text(json.dumps(od))
    return path


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


#: how rank 0 fails to listen when another process took its port between
#: `_free_port` and the bind (the suite runs in several processes at once)
_PORT_TAKEN = ("EADDRINUSE", "Address already in use")


def _cluster(option_files, n_iter, host_batches, torchrun_env=False, attempts=3):
    """Two worker processes, rank i reading option_files[i]: joined through
    the three flags, or through the variables torchrun sets and no flags.
    Returns their outputs. A run whose port was taken before rank 0 bound
    it is made again on another port, up to ``attempts`` runs."""
    for attempt in range(attempts):
        procs, outputs = _run_cluster(_free_port(), option_files, n_iter, host_batches,
                                      torchrun_env)
        failed = any(p.returncode != 0 for p in procs)
        if not (failed and attempt + 1 < attempts
                and any(m in out for out in outputs for m in _PORT_TAKEN)):
            break
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
    return outputs


def _run_cluster(port, option_files, n_iter, host_batches, torchrun_env):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        env.pop(k, None)

    def spawn(pid, opts):
        if torchrun_env:
            args = ["env"] * 3
            rank_env = dict(env, RANK=str(pid), WORLD_SIZE="2", MASTER_ADDR="localhost",
                            MASTER_PORT=str(port), LOCAL_RANK=str(pid))
        else:
            args, rank_env = [f"localhost:{port}", "2", str(pid)], env
        return subprocess.Popen(
            [sys.executable, str(WORKER), *args, str(opts), str(n_iter), str(int(host_batches))],
            cwd=REPO, env=rank_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    procs = [spawn(pid, opts) for pid, opts in enumerate(option_files)]
    try:
        outputs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return procs, outputs


def _single(options, n_iter, host_batches):
    cli.main(["-o", str(options), "--device", "cpu", "--max-iterations", str(n_iter)]
             + (["--host-batches"] if host_batches else []))


def _params(output_dir):
    nets, _, meta = checkpoint.load_train_state(Path(output_dir) / "saved_models")
    return nets, meta


def _assert_equal(multi, single, tag):
    flat_m, flat_s = checkpoint._flatten(multi), checkpoint._flatten(single)
    assert flat_m.keys() == flat_s.keys(), tag
    worst = 0.0
    for k, a in flat_m.items():
        worst = max(worst, float(np.abs(a - flat_s[k]).max()))
        np.testing.assert_allclose(a, flat_s[k], rtol=2e-5, atol=1e-6, err_msg=f"{tag}: {k}")
    print(f"{tag}: two processes against one, worst abs difference {worst:.3e}")


@pytest.fixture(scope="module")
def host_cluster(corpus, tmp_path_factory):
    """Host batches: each rank its own output directory (rank 0 writes)."""
    tmp = tmp_path_factory.mktemp("ddp_host")
    opts = [_options(corpus, tmp / f"rank{r}.json", tmp / f"out{r}") for r in (0, 1)]
    _cluster(opts, N_ITER, host_batches=True)
    _single(_options(corpus, tmp / "single.json", tmp / "single"), N_ITER, host_batches=True)
    return tmp


@pytest.mark.parametrize("host_batches", [True, False])
def test_two_processes_equal_one_process(corpus, host_cluster, tmp_path, host_batches):
    if host_batches:
        multi_dir, single_dir = host_cluster / "out0", host_cluster / "single"
    else:
        shared = _options(corpus, tmp_path / "shared.json", tmp_path / "multi")
        _cluster([shared, shared], N_ITER, host_batches=False)
        _single(_options(corpus, tmp_path / "single.json", tmp_path / "single"), N_ITER, False)
        multi_dir, single_dir = tmp_path / "multi", tmp_path / "single"
    (multi, m_meta), (single, s_meta) = _params(multi_dir), _params(single_dir)
    assert m_meta["step"] == s_meta["step"] == N_ITER
    assert m_meta["np_rng_state"] == s_meta["np_rng_state"]
    assert m_meta["torch_generator_state"] == s_meta["torch_generator_state"]
    _assert_equal(multi, single, "host batches" if host_batches else "device corpus")


def test_torchrun_environment_equals_one_process(corpus, host_cluster, tmp_path):
    """No flags: each process joins the group from RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT (env://) and reads LOCAL_RANK, as under
    torchrun; the parameters equal the one-process run's."""
    opts = [_options(corpus, tmp_path / f"rank{r}.json", tmp_path / f"out{r}") for r in (0, 1)]
    outputs = _cluster(opts, N_ITER, host_batches=True, torchrun_env=True)
    for r, out in enumerate(outputs):
        assert f"process {r} of 2, local rank {r}: done at iteration {N_ITER}" in out
    (multi, m_meta), (single, s_meta) = _params(tmp_path / "out0"), _params(host_cluster / "single")
    assert m_meta["step"] == s_meta["step"] == N_ITER
    assert m_meta["torch_generator_state"] == s_meta["torch_generator_state"]
    assert [f for f in (tmp_path / "out1").rglob("*") if f.is_file()] == []
    _assert_equal(multi, single, "torchrun environment")


def test_only_rank_0_writes(host_cluster):
    written = sorted(str(f.relative_to(host_cluster / "out0"))
                     for f in (host_cluster / "out0").rglob("*") if f.is_file())
    assert "options.json" in written and "saved_models/checkpoint.json" in written
    assert "logs/metrics.jsonl" in written
    assert any(w.startswith("logs/samples/iteration_0_") for w in written)
    assert [f for f in (host_cluster / "out1").rglob("*") if f.is_file()] == []
    log = (host_cluster / "out0" / "logs" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in log] == [0]


def test_two_process_resume_is_lossless(corpus, tmp_path):
    """One epoch on two processes, a fresh pair of processes resumed from
    rank 0's checkpoint for a second epoch: equal to two uninterrupted
    epochs of one process (iteration, epoch, data order and the noise
    generator continue on every rank)."""
    probe = WindowedDataset(corpus / "processed" / "data_definition.json",
                            corpus / "processed" / "processed_data.npz", WINDOW,
                            example_length=small_options().net.style_encoder.example_length)
    bpe = len(probe) // BATCH
    assert bpe >= 2
    first = _options(corpus, tmp_path / "first.json", tmp_path / "multi")
    _cluster([first, first], bpe, host_batches=False)
    resumed = _options(corpus, tmp_path / "resumed.json", tmp_path / "multi", resume=True)
    _cluster([resumed, resumed], 2 * bpe, host_batches=False)
    _single(_options(corpus, tmp_path / "single.json", tmp_path / "single"), 2 * bpe, False)
    (multi, m_meta), (single, s_meta) = _params(tmp_path / "multi"), _params(tmp_path / "single")
    assert m_meta["step"] == s_meta["step"] == 2 * bpe and m_meta["epoch"] == s_meta["epoch"] == 2
    _assert_equal(multi, single, "resume")


def test_batch_slices_of_a_rank(monkeypatch):
    """Rank 1 of 4: rows 2-3 of a batch of 8, every 4th clip from the second."""
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    assert distributed.local_batch_slice(8) == (2, 4)
    assert distributed.host_shard(np.arange(8)).tolist() == [2, 3]
    assert distributed.clip_shard(range(10)) == [1, 5, 9]


def test_batchsize_must_divide_by_the_process_count(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    opts = TC.Options.from_options_json(_options(corpus, tmp_path / "o.json", tmp_path / "out",
                                                 batchsize=7))
    with pytest.raises(ValueError, match="batchsize 7 must divide evenly across 2 processes"):
        Trainer(opts, tmp_path / "m", tmp_path / "l", corpus / "processed" / "processed_data.npz",
                corpus / "processed" / "data_definition.json", device="cpu")


def test_initialize_without_flags_is_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert distributed.local_batch_slice(8) == (0, 8)
    assert distributed.host_shard(np.arange(8)).tolist() == list(range(8))
    assert distributed.clip_shard("abc") == ["a", "b", "c"]
    with pytest.raises(ValueError, match="go together"):
        distributed.initialize("localhost:1", 2, None, device="cpu")
