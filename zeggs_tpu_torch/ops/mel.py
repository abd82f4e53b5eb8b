"""Mel-spectrogram audio front end (counterpart of `zeggs_tpu/ops/mel.py`).

Chain (v1 config): symmetric-Hann STFT magnitude / n_fft -> Slaney mel
filterbank -> clip at min_amplitude/n_fft -> dB -> dynamic range mapped
to [0, 1] -> 10**(x/20) then ln -> linear resample to the 60 fps animation
grid, plus an energy channel. The filterbank and window are built with
numpy once, as in the reference. The STFT-to-dB part is one launch of the
mel kernel on a card (`ops/kernels/mel.py`); CPU tensors take its plain
version, `torch.fft.rfft` and a matmul.
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
