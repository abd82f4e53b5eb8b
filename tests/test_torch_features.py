"""zeggs_tpu_torch featurizers against zeggs_tpu's.

Audio: the mel budget of tests/test_pallas_kernels.py, atol 2e-4.
Animation: atol 1e-4 on positions, rotations and rot6d. Velocities are
finite differences over dt = 1/60 s, which turn a one-ulp difference in a
position of ~100 cm into ~5e-4; they are compared as per-frame
displacements (velocity * dt), in the positions' units, at the same 1e-4.
"""

import dataclasses
from collections import Counter

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
    ours = TF.preprocess_audio(x, 60, 120, tcfg, device="cpu").numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)


def test_filterbank_and_window_are_the_reference_ones():
    np.testing.assert_array_equal(tmel.mel_filterbank(800, 16000, 80, 20.0, 7600.0),
                                  jmel.mel_filterbank(800, 16000, 80, 20.0, 7600.0))
    np.testing.assert_array_equal(tmel.hann_symmetric(800), jmel.hann_symmetric(800))


@pytest.mark.parametrize("nframes", [240, 241])
def test_preprocess_animation_matches_jax(nframes):
    anim = make_motion(nframes, seed=5)
    ref = JF.preprocess_animation(anim)
    ours = TF.preprocess_animation(anim, device="cpu")
    for f in dataclasses.fields(ref):
        a = np.asarray(getattr(ref, f.name))
        b = getattr(ours, f.name).numpy()
        assert a.shape == b.shape, f.name
        scale = DT if f.name in VELOCITIES else 1.0
        np.testing.assert_allclose(b * scale, a * scale, atol=1e-4, rtol=0, err_msg=f.name)


def _wrapping(nframes, seed):
    """A clip whose joint 1 turns from 150 to 210 degrees about z: its Euler
    angle wraps from +180 to -180 there, the quaternions change sign, and
    `quat.unroll` flips every frame after the wrap."""
    anim = make_motion(nframes, seed=seed)
    anim["rotations"][:, 1, 0] = (np.linspace(150.0, 210.0, nframes) + 180.0) % 360.0 - 180.0
    return anim


# name -> clips, as (frame count, seed, made by)
MIXES = {
    "equal_lengths": [(64, 1, make_motion), (64, 2, make_motion), (64, 3, make_motion)],
    "two_lengths": [(64, 1, make_motion), (80, 2, make_motion), (64, 3, make_motion),
                    (80, 4, make_motion), (80, 5, make_motion)],
    "one_clip": [(64, 6, make_motion)],
    "unroll_flips": [(64, 7, make_motion), (64, 8, _wrapping), (64, 9, make_motion)],
}


@pytest.mark.parametrize("mix", list(MIXES))
def test_batched_animations_equal_each_clip_alone(mix, monkeypatch):
    """`preprocess_animations` over a mix of clips gives each clip every
    field `preprocess_animation` gives it alone, bit for bit, in one pass a
    group of clips of one frame count."""
    anims = [made(n, seed) for n, seed, made in MIXES[mix]]
    if mix == "unroll_flips":
        from zeggs_tpu_torch.ops import quat as tq

        q = tq.from_euler(torch.deg2rad(torch.as_tensor(anims[1]["rotations"])), "zyx")
        assert not torch.equal(tq.unroll(q), q)
    passes, extract = [], TF.extract_anim_features

    def counted(rotations_deg, *args, **kwargs):
        passes.append(len(rotations_deg))
        return extract(rotations_deg, *args, **kwargs)

    monkeypatch.setattr(TF, "extract_anim_features", counted)
    batched = TF.preprocess_animations(anims, device="cpu")
    assert sorted(passes) == sorted(Counter(n for n, *_ in MIXES[mix]).values())
    assert len(batched) == len(anims)
    for anim, ours in zip(anims, batched):
        alone = TF.preprocess_animation(anim, device="cpu")
        for f in dataclasses.fields(alone):
            a, b = getattr(alone, f.name), getattr(ours, f.name)
            assert a.shape == b.shape and a.shape[0] == len(anim["rotations"]), f.name
            assert torch.equal(a, b), f.name


def test_gaze_median_averages_the_middle_pair():
    """An even frame count: the gaze point is the mean of the two middle
    values, as jnp.median gives (torch.median would take the lower)."""
    x = torch.tensor([[[1.0], [4.0], [2.0], [3.0]]])  # one clip of 4 frames
    assert TF._median_time(x).item() == 2.5
    assert TF._median_time(x[:, :3]).item() == 2.0


@pytest.mark.parametrize("featurizer", ["audio", "animation", "anim_features"])
def test_featurizers_default_to_the_card(monkeypatch, featurizer):
    """Without ``device`` the featurizers run on the card, and raise where
    there is none instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    anim = make_motion(8, seed=5)
    calls = {
        "audio": lambda: TF.preprocess_audio(make_audio(0.1, seed=4), 60, 6, TC.MelConfig()),
        "animation": lambda: TF.preprocess_animation(anim),
        "anim_features": lambda: TF.extract_anim_features(
            anim["rotations"], anim["positions"], list(anim["parents"]), list(anim["names"]), DT),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[featurizer]()
