"""ITU-R BS.1770-4 integrated loudness + normalization (the port's own copy
of `zeggs_tpu/audio/loudness.py`, numpy and scipy only).

The reference optionally loudness-normalizes every clip to -20 LUFS through
the `pyloudnorm` package (ZEGGS/data_pipeline.py:34-39). That package is not
available here, so this is a from-scratch implementation of the same
standard: K-weighting (high-shelf + high-pass biquads) -> 400 ms blocks with
75% overlap -> absolute (-70 LUFS) and relative (-10 LU) gating -> integrated
loudness; normalization applies the linear gain to the target.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import lfilter


def _high_shelf_coeffs(fs, g_db=3.9996880565770647, q=0.7071752369553183, fc=1500.3189887377089):
    # RBJ high-shelf parameterization fitted to the exact ITU-R BS.1770-4
    # 48 kHz table coefficients (max deviation 5e-5), generalized to any fs.
    a = 10.0 ** (g_db / 40.0)
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    sq = 2.0 * math.sqrt(a) * alpha
    b = np.array(
        [
            a * ((a + 1) + (a - 1) * cw + sq),
            -2 * a * ((a - 1) + (a + 1) * cw),
            a * ((a + 1) + (a - 1) * cw - sq),
        ]
    )
    a_ = np.array(
        [
            (a + 1) - (a - 1) * cw + sq,
            2 * ((a - 1) - (a + 1) * cw),
            (a + 1) - (a - 1) * cw - sq,
        ]
    )
    return b / a_[0], a_ / a_[0]


def _high_pass_coeffs(fs, q=0.5003270373238773, fc=38.13547087602444):
    w0 = 2.0 * math.pi * fc / fs
    alpha = math.sin(w0) / (2.0 * q)
    cw = math.cos(w0)
    # ITU uses a unity-at-Nyquist numerator [1, -2, 1] (not the RBJ-normalized
    # one) — matches the BS.1770-4 48 kHz table exactly.
    b = np.array([1.0, -2.0, 1.0])
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    return b, a / a[0]


def k_weight(x, fs):
    """Apply the two-stage K-weighting pre-filter."""
    b1, a1 = _high_shelf_coeffs(fs)
    b2, a2 = _high_pass_coeffs(fs)
    y = lfilter(b1, a1, x, axis=0)
    return lfilter(b2, a2, y, axis=0)


def integrated_loudness(x, fs, block_s=0.400, overlap=0.75):
    """Gated integrated loudness in LUFS for mono or (T, C) audio."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    y = k_weight(x, fs)

    block = int(round(block_s * fs))
    step = int(round(block * (1.0 - overlap)))
    n = y.shape[0]
    if n < block:
        raise ValueError("audio shorter than one 400 ms gating block")
    n_blocks = (n - block) // step + 1
    idx = np.arange(block)[None, :] + step * np.arange(n_blocks)[:, None]
    ms = np.mean(y[idx] ** 2, axis=1)  # (n_blocks, C)
    # channel weights: 1.0 for the first 3 channels, 1.41 for surround
    weights = np.ones(y.shape[1])
    if y.shape[1] > 3:
        weights[3:5] = 1.41
    z = ms @ weights  # (n_blocks,)
    with np.errstate(divide="ignore"):
        lk = -0.691 + 10.0 * np.log10(z)

    abs_gate = lk > -70.0
    if not abs_gate.any():
        return -np.inf
    z_abs = z[abs_gate].mean()
    rel_thresh = -0.691 + 10.0 * np.log10(z_abs) - 10.0
    gated = abs_gate & (lk > rel_thresh)
    if not gated.any():
        return -np.inf
    return -0.691 + 10.0 * np.log10(z[gated].mean())


def normalize_loudness(x, fs, target_lufs=-20.0):
    """Scale audio so its integrated loudness hits ``target_lufs``
    (pyloudnorm.normalize.loudness semantics)."""
    current = integrated_loudness(x, fs)
    if not np.isfinite(current):
        return np.asarray(x, dtype=np.float32)
    gain = 10.0 ** ((target_lufs - current) / 20.0)
    return (np.asarray(x, dtype=np.float64) * gain).astype(np.float32)
