"""The port's windowed dataset and device corpus on the CPU against
zeggs_tpu's `WindowedDataset`, on one processed corpus: for the same
`np.random.Generator` state, `make_batch`, `sample_example_length` and
`get_sample` make the same draws in the same order and give bit-identical
arrays; `DeviceCorpus.gather_batch` equals the host batch exactly, for
example and label styles."""

import numpy as np
import pytest
import torch

from zeggs_tpu.data.dataset import WindowedDataset as JaxDataset
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.data.dataset import WindowedDataset
from zeggs_tpu_torch.data.device_dataset import DeviceCorpus
from zeggs_tpu_torch.data.pipeline import data_pipeline
from tests.synthetic import write_raw_corpus

WINDOW, EXAMPLE = 32, 64


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataset_corpus")
    write_raw_corpus(root, n_clips=3, seconds=4.0)
    data_pipeline(TC.PipelineConfig(
        base_path=str(root), processed_data_path="processed", info_filename="info.csv",
        audio_conf=TC.MelConfig(normalize_loudness=False), len_ratios=(0.9, 1.0),
        save_trimmed_audio=False, save_trimmed_animation=False), device="cpu")
    return root / "processed"


def _pair(processed, style):
    args = (processed / "data_definition.json", processed / "processed_data.npz", WINDOW)
    kw = dict(style_encoding_type=style, example_length=EXAMPLE)
    return WindowedDataset(*args, **kw), JaxDataset(*args, **kw)


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("style", ["example", "label"])
def test_batches_and_draws_are_bit_identical(processed, style):
    ours, ref = _pair(processed, style)
    assert len(ours) == len(ref) > 0 and ours.get_shapes() == ref.get_shapes()
    np.testing.assert_array_equal(ours.window_starts, ref.window_starts)
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        idx_a, idx_b = ra.permutation(len(ours))[:5], rb.permutation(len(ref))[:5]
        np.testing.assert_array_equal(idx_a, idx_b)
        if style == "example":
            assert ours.sample_example_length(ra) == ref.sample_example_length(rb)
        _assert_batches_equal(ours.make_batch(idx_a, rng=ra), ref.make_batch(idx_b, rng=rb))
    for which in ("train", "valid"):
        sa, la, ra_, ia = ours.get_sample(which, 2, rng=ra)
        sb, lb, rb_, ib = ref.get_sample(which, 2, rng=rb)
        assert (la, ra_, ia) == (lb, rb_, ib)
        _assert_batches_equal(sa, sb)
    assert ra.bit_generator.state == rb.bit_generator.state


def test_device_corpus_gathers_the_host_batch(processed):
    ds, _ = _pair(processed, "example")
    corpus = DeviceCorpus(ds, device="cpu")
    idx = np.random.default_rng(5).integers(0, len(ds), size=4)
    for ewl in (64, 96, 128):
        host = ds.make_batch(idx, example_window_length=ewl)
        dev = corpus.gather_batch(*corpus.sample_indices(idx, ewl))
        assert set(dev) == set(host)
        for k in host:
            np.testing.assert_array_equal(dev[k].numpy(), host[k], err_msg=k)


def test_device_corpus_label_batch(processed):
    ds, _ = _pair(processed, "label")
    corpus = DeviceCorpus(ds, device="cpu")
    idx = np.arange(0, len(ds), 7)[:6]
    host = ds.make_batch(idx)
    dev = corpus.gather_batch(torch.as_tensor(ds.window_starts[idx]),
                              labels=ds.window_labels[idx], nlabels=ds.nlabels)
    assert set(dev) == set(host)
    for k in host:
        np.testing.assert_array_equal(dev[k].numpy(), host[k], err_msg=k)


def test_device_corpus_needs_its_device(processed):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    ds, _ = _pair(processed, "example")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCorpus(ds)
