"""zeggs_tpu_torch featurizers against zeggs_tpu's.

Audio: the mel budget of tests/test_pallas_kernels.py, atol 2e-4.
Animation: atol 1e-4 on positions, rotations and rot6d. Velocities are
finite differences over dt = 1/60 s, which turn a one-ulp difference in a
position of ~100 cm into ~5e-4; they are compared as per-frame
displacements (velocity * dt), in the positions' units, at the same 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zeggs_tpu.data import features as JF
from zeggs_tpu.ops import mel as jmel
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.data import features as TF
from zeggs_tpu_torch.ops import mel as tmel
from tests.synthetic import make_audio, make_motion

DT = 1.0 / 60.0
VELOCITIES = {"root_vel", "root_vrt", "lvel", "lvrt", "cvel", "cvrt"}


def _cfgs(**kw):
    return jmel.MelConfig(**kw), TC.MelConfig(**kw)


@pytest.mark.parametrize("seconds", [0.03, 1.5, 2.0])
def test_mel_spectrogram_matches_jax(seconds):
    jcfg, tcfg = _cfgs(normalize_loudness=False)
    x = make_audio(seconds, seed=2)
    ref = np.asarray(jmel.mel_spectrogram_tts(jnp.asarray(x), jcfg))
    ours = tmel.mel_spectrogram_tts(torch.as_tensor(x), tcfg).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("seconds", [1.0, 2.5])
def test_audio_features_match_jax(seconds):
    jcfg, tcfg = _cfgs(normalize_loudness=False)
    x = make_audio(seconds, seed=3)
    n = int(round(60 * seconds))
    ref = np.asarray(jmel.audio_features(jnp.asarray(x), 60, n, jcfg))
    ours = tmel.audio_features(torch.as_tensor(x), 60, n, tcfg).numpy()
    assert ours.shape == ref.shape == (n, 81)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)


def test_preprocess_audio_with_loudness_matches_jax():
    jcfg, tcfg = _cfgs(normalize_loudness=True)
    x = make_audio(2.0, seed=4)
    ref = JF.preprocess_audio(x, 60, 120, jcfg)
    ours = TF.preprocess_audio(x, 60, 120, tcfg).numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)


def test_filterbank_and_window_are_the_reference_ones():
    np.testing.assert_array_equal(tmel.mel_filterbank(800, 16000, 80, 20.0, 7600.0),
                                  jmel.mel_filterbank(800, 16000, 80, 20.0, 7600.0))
    np.testing.assert_array_equal(tmel.hann_symmetric(800), jmel.hann_symmetric(800))


@pytest.mark.parametrize("nframes", [240, 241])
def test_preprocess_animation_matches_jax(nframes):
    anim = make_motion(nframes, seed=5)
    ref = JF.preprocess_animation(anim)
    ours = TF.preprocess_animation(anim)
    for f in dataclasses.fields(ref):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(ours, f.name).numpy()
        assert a.shape == b.shape, f.name
        scale = DT if f.name in VELOCITIES else 1.0
        np.testing.assert_allclose(b * scale, a * scale, atol=1e-4, rtol=0, err_msg=f.name)


def test_gaze_median_averages_the_middle_pair():
    """An even frame count: the gaze point is the mean of the two middle
    values, as jnp.median gives (torch.median would take the lower)."""
    x = torch.tensor([[1.0], [4.0], [2.0], [3.0]])
    assert TF._median_time(x).item() == 2.5
    assert TF._median_time(x[:3]).item() == 2.0
