"""The mel core of zeggs_tpu_torch (`ops/kernels/mel.py`) on the CPU against
zeggs_tpu's Pallas mel kernel, run in interpret mode as
tests/test_pallas_kernels.py runs it, and against zeggs_tpu's features.

On the CPU the wrapper takes the kernel's plain version (`torch.fft.rfft`
and a matmul); the CUDA kernel is held to that plain version on the card
(tests/test_torch_cuda.py). Budgets: 2e-4 on the normalised dB rows, the
budget of tests/test_pallas_kernels.py, which the DFT of the Pallas kernel
needs against an FFT; 1e-5 on the features against zeggs_tpu's default
chain, which is an FFT too (measured: 2e-6).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import jax.numpy as jnp

from zeggs_tpu.ops import mel as jmel
from zeggs_tpu.ops.pallas import fused_mel_spectrogram
from zeggs_tpu_torch import config as TC
from zeggs_tpu_torch.ops import mel as tmel
from zeggs_tpu_torch.ops.kernels import mel as K
from tests.synthetic import make_audio

TOL = 2e-4
FEATURES_TOL = 1e-5
JCFG = jmel.MelConfig(normalize_loudness=False)
TCFG = TC.MelConfig(normalize_loudness=False)
CPU = torch.device("cpu")


def _padded(x):
    """The reference's padding of a clip (to n_fft, then reflected)."""
    t = torch.as_tensor(x)
    if t.shape[0] < 800:
        t = TF.pad(t, (0, 800 - t.shape[0]))
    return TF.pad(t[None, None], (400, 400), mode="reflect")[0, 0].contiguous()


@pytest.fixture(scope="module")
def clip():
    x = make_audio(1.5, seed=2)
    return x, np.asarray(fused_mel_spectrogram(jnp.asarray(x), JCFG))


@pytest.mark.parametrize("seconds", [1.5, 0.03])
def test_mel_spectrogram_matches_pallas_kernel(seconds):
    x = make_audio(seconds, seed=2)
    ref = np.asarray(fused_mel_spectrogram(jnp.asarray(x), JCFG))
    ours = tmel.mel_spectrogram_tts(torch.as_tensor(x), TCFG).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=0)
    padded = _padded(x)
    plain = K.mel_frames_plain(padded, ref.shape[0], K.mel_consts(TCFG, CPU)).numpy()
    np.testing.assert_allclose(plain, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("nf,t0", [(1, 0), (2, 57), (8, 40), (32, 88)])
def test_streaming_windows_match_pallas_rows(clip, nf, t0):
    """A streaming window of nf frames, cut from the padded clip at frame
    t0, gives rows t0 .. t0+nf-1 of the whole clip's spectrogram."""
    x, ref = clip
    window = _padded(x)[t0 * 200 : t0 * 200 + (nf - 1) * 200 + 800].contiguous()
    launches = K.launches
    ours = K.mel_frames(window, nf, TCFG)
    assert K.launches == launches, "CPU tensors take the plain version"
    assert tuple(ours.shape) == (nf, 80)
    np.testing.assert_allclose(ours.numpy(), ref[t0 : t0 + nf], atol=TOL, rtol=0)


def test_zero_window_clips_to_the_floor():
    """finish() may hand the core zero samples: they clip to min_amp, which
    normalises to 0, and give no NaN."""
    for nf in (1, 8):
        out = K.mel_frames(torch.zeros((nf - 1) * 200 + 800), nf, TCFG)
        assert torch.isfinite(out).all()
        torch.testing.assert_close(out, torch.zeros(nf, 80), atol=1e-6, rtol=0)


@pytest.mark.parametrize("n", [1, 799, 800, 801, 1000, 1200, 16000, 16199])
def test_frame_count_convention(n):
    """One frame fewer when the padded length is a multiple of the hop."""
    n_padded = max(n, 800) + 800
    assert tmel.num_frames(n_padded, 800, 200) == jmel.num_frames(n, 800, 200)
    x = make_audio(n / 16000, seed=5)[:n]
    assert tmel.mel_spectrogram_tts(torch.as_tensor(x), TCFG).shape[0] == jmel.num_frames(n, 800, 200)


@pytest.mark.parametrize("fused", [None, False, True])
def test_audio_features_match_jax(fused):
    x = make_audio(2.0, seed=3)
    ref = np.asarray(jmel.audio_features(jnp.asarray(x), 60, 120, JCFG))
    ours = tmel.audio_features(torch.as_tensor(x), 60, 120, TCFG, fused=fused).numpy()
    assert ours.shape == ref.shape == (120, 81)
    np.testing.assert_allclose(ours, ref, atol=FEATURES_TOL, rtol=0)


def test_constants():
    c = K.mel_consts(TCFG, CPU)
    assert K.mel_consts(TCFG, CPU) is c
    basis = jmel.mel_filterbank(800, 16000, 80, 20.0, 7600.0, True)
    np.testing.assert_array_equal(c.basis.numpy(), basis)
    for m, (lo, hi) in enumerate(c.support.tolist()):
        assert lo < hi and basis[m, lo] != 0 and basis[m, hi - 1] != 0
        assert not basis[m, :lo].any() and not basis[m, hi:].any()
    assert c.plan is K.fft_plan(800)
    np.testing.assert_array_equal(c.twiddles.numpy(), c.plan.twiddles)
    assert c.min_amp == 1e-5 / 800 and c.amp_scale == 1 / 800
    assert math.isclose(c.dyn_range, -20 * math.log10(1e-5 / 800))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        K.mel_frames(torch.zeros(1000, dtype=torch.float64), 2, TCFG)
    with pytest.raises(ValueError, match="need 1000 samples"):
        K.mel_frames(torch.zeros(999), 2, TCFG)
    with pytest.raises(ValueError, match="contiguous"):
        K.mel_frames(torch.zeros(2000)[::2], 2, TCFG)
    with pytest.raises(ValueError, match="at least 1"):
        K.mel_frames(torch.zeros(1000), 0, TCFG)
