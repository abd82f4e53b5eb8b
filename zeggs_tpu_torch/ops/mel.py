"""Mel-spectrogram audio front end (counterpart of `zeggs_tpu/ops/mel.py`).

Chain (v1 config): symmetric-Hann STFT magnitude / n_fft -> Slaney mel
filterbank -> clip at min_amplitude/n_fft -> dB -> dynamic range mapped
to [0, 1] -> 10**(x/20) then ln -> linear resample to the 60 fps animation
grid, plus an energy channel. The filterbank and window are built with
numpy once, as in the reference. The STFT-to-dB part is one launch of the
mel kernel on a card (`ops/kernels/mel.py`); CPU tensors take its plain
version, `torch.fft.rfft` and a matmul.

The inverse path (dB and range undoing, mel -> linear inversion and
Griffin-Lim phase reconstruction) runs as plain PyTorch on the given
tensors' device, `torch.fft` and an `index_add_` overlap-add, as the JAX
package computes it with `jnp.fft` outside any kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MelConfig
from .kernels import mel as K


def _hz_to_mel(frequencies):
    """Slaney-style Hz -> mel."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = frequencies / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    log_step = np.log(6.4) / 27.0
    log_t = frequencies >= min_log_hz
    return np.where(
        log_t, min_log_mel + np.log(np.maximum(frequencies, 1e-30) / min_log_hz) / log_step, mels
    )


def _mel_to_hz(mels):
    """Slaney-style mel -> Hz."""
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    log_step = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(log_step * (mels - min_log_mel)), freqs)


def mel_filterbank(n_fft, fs, n_mels=80, mel_fmin=0.0, mel_fmax=None, normalize_mel_bins=True):
    """(n_mels, 1 + n_fft//2) triangular filterbank, numpy float32."""
    if mel_fmax is None:
        mel_fmax = float(fs) / 2
    n_bins = int(1 + n_fft // 2)
    fft_freqs = np.linspace(0, float(fs) / 2, n_bins, endpoint=True)
    mels = np.linspace(_hz_to_mel(mel_fmin), _hz_to_mel(mel_fmax), n_mels + 2)
    mel_f = _mel_to_hz(mels)
    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fft_freqs)
    weights = np.zeros((n_mels, n_bins))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    if normalize_mel_bins:
        enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
        weights *= enorm[:, np.newaxis]
    return weights.astype(np.float32)


def hann_symmetric(n):
    """Symmetric Hann window, as ``scipy.signal.hann(n)`` (sym=True)."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))).astype(np.float32)


def preemphasis(x, coeff=0.97):
    """y[n] = x[n] - coeff*x[n-1], y[0] = x[0]."""
    return torch.cat([x[:1], x[1:] - coeff * x[:-1]])


def num_frames(n_padded, n_fft, step_size):
    """Frames of a padded signal of ``n_padded`` samples, the reference's
    convention: one frame fewer than a plain sliding window when the padded
    length is a multiple of the hop."""
    frames = (n_padded - n_fft) // step_size
    return frames if n_padded % step_size == 0 else frames + 1


def num_wav_samples(spectrogram_length, n_fft, step_size, centered=True):
    """WAV samples covered by a spectrogram of ``spectrogram_length`` frames
    (centred extraction pads n_fft // 2 on each side, subtracted back)."""
    pad = 2 * (n_fft // 2) if centered else 0
    return (spectrogram_length - 1) * step_size + n_fft - pad


def pre_emphasis_on_mel(mel_spec, preemph, fs, n_mels, mel_fmin=0.0, mel_fmax=None,
                        min_amplitude=None, normalized_range=True):
    """Pre-emphasis applied in the (log, range-normalised) mel domain of an
    (n_mels, T) numpy spectrogram: the FIR [1, -preemph] response at the
    mel-bin centres in dB (over the normalisation range when the spectrogram
    is normalised), with the reference's empirical correction for
    min_amplitude 1e-5 and preemph 0.97. Host-side numpy/scipy."""
    import scipy.signal as sps

    if mel_fmax is None:
        mel_fmax = float(fs) / 2
    mels = np.linspace(_hz_to_mel(mel_fmin), _hz_to_mel(mel_fmax), n_mels + 2)
    bin_freqs = _mel_to_hz(mels)
    w, h = sps.freqz(b=[1, -preemph], a=[1], worN=bin_freqs[1:-1], fs=fs)
    h = 20 * np.log10(np.abs(h))
    h = np.tile(h[:, None], (1, np.asarray(mel_spec).shape[1]))
    if normalized_range:
        dbr = -20 * np.log10(min_amplitude)
        h = h / dbr
    if min_amplitude == 1e-5 and preemph == 0.97:
        correction = np.log(w) / 30 - 0.277
        h = h - np.tile(correction[:, None], (1, h.shape[1]))
    return np.add(mel_spec, h)


def stft_magnitude(x, window, n_fft, step_size, real_amplitude=True, centered=True):
    """|STFT| of a 1-D signal as (T, n_fft // 2 + 1), with the reference's
    padding and frame count: frames gathered by index and one batched
    `torch.fft.rfft`."""
    if x.shape[0] < n_fft:
        x = F.pad(x, (0, n_fft - x.shape[0]))
    if centered:
        pad = n_fft // 2
        x = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    frames = num_frames(x.shape[0], n_fft, step_size)
    idx = (torch.arange(frames, device=x.device)[:, None] * step_size
           + torch.arange(n_fft, device=x.device)[None, :])
    amp = torch.abs(torch.fft.rfft(x[idx] * window[None, :], dim=-1))
    return amp / n_fft if real_amplitude else amp


def mel_spectrogram_tts(x, cfg: MelConfig, fused=None):
    """Normalised-dB mel spectrogram, (T, n_mels): the reference's padding
    (to n_fft, then n_fft/2 reflected on each side when centered), then the
    mel core of `ops/kernels/mel.py` on the padded signal. ``fused``: None
    or True run `mel_frames`, the kernel on a CUDA tensor and its plain
    version on a CPU tensor; False runs the plain version on any device."""
    if cfg.pre_emphasis:
        x = preemphasis(x, cfg.pre_emph_coeff)
    n_fft = cfg.filter_length
    if x.shape[0] < n_fft:
        x = F.pad(x, (0, n_fft - x.shape[0]))
    if cfg.centered:
        pad = n_fft // 2
        x = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    x = x.contiguous()
    T = num_frames(x.shape[0], n_fft, cfg.hop_length)
    if fused is False:
        return K.mel_frames_plain(x, T, K.mel_consts(cfg, x.device))
    return K.mel_frames(x, T, cfg)


def linear_resample(y, t_new, extrapolate=False):
    """Linear interpolation of (T, C) rows at fractional indices ``t_new``;
    ``extrapolate=False`` clamps to the hull."""
    T = y.shape[0]
    if not extrapolate:
        t_new = torch.clamp(t_new, 0.0, T - 1.0)
    i0 = torch.clamp(torch.floor(t_new).to(torch.int64), 0, T - 2)
    frac = (t_new - i0).reshape((-1,) + (1,) * (y.ndim - 1))
    return y[i0] * (1.0 - frac) + y[i0 + 1] * frac


def audio_features(audio, anim_fs, anim_length, cfg: MelConfig,
                   feature_type=("mel_spec", "energy"), fused=None):
    """Per-clip audio features -> (anim_length, n_features): log-mel and
    energy resampled to the animation grid. ``audio`` is a 1-D float32
    tensor; the result lies on its device. ``fused``: see
    `mel_spectrogram_tts`; the default takes the kernel on a card."""
    mel_norm_db = mel_spectrogram_tts(audio, cfg, fused)
    mel = 10.0 ** (mel_norm_db / 20.0)
    log_mel = torch.log(mel)
    step = (cfg.sampling_rate / cfg.hop_length) / anim_fs
    t_new = step * torch.arange(anim_length, device=audio.device, dtype=torch.float32)
    feats = []
    if "mel_spec" in feature_type:
        feats.append(linear_resample(log_mel, t_new, extrapolate=False))
    if "energy" in feature_type:
        energy = torch.linalg.norm(mel, dim=-1)
        feats.append(linear_resample(energy[:, None], t_new, extrapolate=True))
    return torch.cat(feats, dim=-1)


# ---------------------------------------------------------------------------
# inverse path: dB utilities, mel inversion, Griffin-Lim
# ---------------------------------------------------------------------------

def db_to_amplitude(spectrogram):
    return 10.0 ** (spectrogram / 20.0)


def denormalize_range(spectrogram, min_amplitude_used):
    """Undo the [0, 1] dynamic-range mapping (the range in float32, as the
    JAX package computes it)."""
    dynamic_range = -20.0 * torch.log10(torch.tensor(min_amplitude_used, dtype=torch.float32))
    return spectrogram * dynamic_range.to(spectrogram.device) - dynamic_range.to(
        spectrogram.device)


def mel_to_linear(mel_spectrogram, fs, n_fft, mel_fmin=0.0, mel_fmax=None,
                  normalize_mel_bins=False):
    """Approximate mel -> linear inversion through the row-normalised
    transposed filterbank: (T, n_mels) -> (T, n_fft // 2 + 1)."""
    n_mels = mel_spectrogram.shape[-1]
    basis = mel_filterbank(n_fft, fs, n_mels, mel_fmin, mel_fmax, normalize_mel_bins)
    basis = basis / basis.sum(axis=1, keepdims=True)
    return mel_spectrogram @ torch.as_tensor(basis, device=mel_spectrogram.device)


def griffin_lim(magnitude, step_size, n_fft=None, iterations=30, generator=None, signal=None):
    """Griffin-Lim phase reconstruction of a (T, n_fft // 2 + 1) linear
    magnitude tensor -> the time signal, on the magnitude's device.

    The first signal is ``signal`` (len T * step_size + n_fft samples) when
    given, else a standard normal draw from ``generator`` (on the
    magnitude's device; None: a generator seeded with 0). Each iteration
    frames the signal, takes the rFFT's phase with the given magnitude,
    inverts, and overlap-adds the windowed frames with `index_add_`."""
    magnitude = torch.as_tensor(magnitude, dtype=torch.float32)
    dev = magnitude.device
    T, bins = magnitude.shape
    if n_fft is None:
        n_fft = (bins - 1) * 2
    len_samples = int(T * step_size + n_fft)
    window = torch.as_tensor(np.hanning(n_fft).astype(np.float32), device=dev)
    idx = (torch.arange(T, device=dev)[:, None] * step_size
           + torch.arange(n_fft, device=dev)[None, :])
    if signal is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(len_samples, generator=generator, device=dev, dtype=torch.float32)
    else:
        x = torch.as_tensor(signal, dtype=torch.float32, device=dev)
        if x.shape != (len_samples,):
            raise ValueError(f"signal must have {len_samples} samples, got {tuple(x.shape)}")
    norm = n_fft / step_size / 2.0
    flat = idx.reshape(-1)
    for _ in range(iterations):
        spec = torch.fft.rfft(x[idx] * window[None, :], dim=-1)
        proposal = magnitude * torch.exp(1j * torch.angle(spec))
        recon = torch.fft.irfft(proposal, n=n_fft, dim=-1) * window[None, :]
        x = torch.zeros(len_samples, device=dev).index_add_(0, flat, recon.reshape(-1)) / norm
    return x
