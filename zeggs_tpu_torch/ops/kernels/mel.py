"""Fused STFT magnitude + mel filterbank + dB: the CUDA kernel
(csrc/mel_spectrogram.cu), its constants, its plain PyTorch version and its
launch count.

Replaces `zeggs_tpu/ops/pallas/mel_kernel.py::fused_mel_spectrogram`. The
core takes a signal that is already padded (and pre-emphasised) and a frame
count T, and returns (T, n_mels): frame t is x[t*hop : t*hop + n_fft] times
the symmetric Hann window, then |rFFT| * amp_scale, the mel filterbank,
clip at min_amp, 20 log10 and, with ``normalize_range``, (db + dyn) / dyn.
`ops/mel.py::mel_spectrogram_tts` pads a clip and calls the core; the
streaming front end calls it on each ready window of samples.

Constants are made once per (config, device) with the numpy functions the
JAX package uses; the kernel reads the DFT twiddles from one table of
n_fft (cos, sin) pairs computed in float64, and each mel filter only over
its nonzero bins.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ...config import MelConfig
from . import build

#: launches of the CUDA kernel in this process; the plain version on CPU
#: tensors does not count
launches = 0


@dataclasses.dataclass(frozen=True)
class MelConsts:
    """A `MelConfig`'s constants on one device."""

    window: torch.Tensor  # (n_fft,) symmetric Hann
    twiddle: torch.Tensor  # (n_fft, 2) cos, sin of 2 pi j / n_fft
    basis: torch.Tensor  # (n_mels, n_bins) mel filterbank
    support: torch.Tensor  # (n_mels, 2) int32 [first, last + 1) nonzero bin of each filter
    n_fft: int
    hop: int
    amp_scale: float  # 1 / n_fft with real_amplitude, else 1
    min_amp: float
    dyn_range: float
    normalize: bool

    @property
    def n_mels(self):
        return self.basis.shape[0]


@functools.lru_cache(maxsize=16)
def mel_consts(cfg: MelConfig, device) -> MelConsts:
    """The constants of ``cfg`` on ``device``, built once."""
    from ..mel import hann_symmetric, mel_filterbank

    n_fft = cfg.filter_length
    basis = mel_filterbank(n_fft, cfg.sampling_rate, cfg.n_mel_channels, cfg.mel_fmin,
                           cfg.mel_fmax, cfg.normalize_mel_bins)
    nonzero = basis != 0
    first = np.where(nonzero.any(1), nonzero.argmax(1), 0)
    last = np.where(nonzero.any(1), basis.shape[1] - nonzero[:, ::-1].argmax(1), 0)
    ang = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    min_amp = cfg.min_clipping / (n_fft if cfg.real_amplitude else 1)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return MelConsts(
        window=dev(hann_symmetric(n_fft)),
        twiddle=dev(np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)),
        basis=dev(basis),
        support=dev(np.stack([first, last], 1).astype(np.int32)),
        n_fft=n_fft, hop=cfg.hop_length,
        amp_scale=1.0 / n_fft if cfg.real_amplitude else 1.0,
        min_amp=min_amp, dyn_range=-20.0 * math.log10(min_amp),
        normalize=cfg.normalize_range,
    )


def mel_frames_plain(x, n_frames, c: MelConsts):
    """The kernel's function in PyTorch: padded signal (n,) -> (n_frames,
    n_mels) through `torch.fft.rfft` and a matmul."""
    windowed = x.unfold(0, c.n_fft, c.hop)[:n_frames] * c.window
    amp = torch.abs(torch.fft.rfft(windowed, dim=-1)) * c.amp_scale
    mel = torch.clamp(torch.abs(amp @ c.basis.T), min=c.min_amp)
    db = 20.0 * torch.log10(mel)
    return (db + c.dyn_range) / c.dyn_range if c.normalize else db


def _check(x, n_frames, c: MelConsts):
    if x.ndim != 1 or x.dtype != torch.float32:
        raise TypeError(f"x must be a 1-D float32 tensor, got {x.dtype} of shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if n_frames < 1:
        raise ValueError(f"n_frames must be at least 1, got {n_frames}")
    need = (n_frames - 1) * c.hop + c.n_fft
    if x.shape[0] < need:
        raise ValueError(f"{n_frames} frames need {need} samples, got {x.shape[0]}")
    if c.window.device != x.device:
        raise ValueError(f"the constants are on {c.window.device}, x on {x.device}")


@functools.cache
def _library():
    lib = build.load("mel_spectrogram")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.zeggs_mel_spectrogram.argtypes = [p, i, p, p, p, p, p, i, i, i, f, f, f, i, p]
    lib.zeggs_mel_spectrogram.restype = i
    lib.zeggs_mel_error_string.argtypes = [i]
    lib.zeggs_mel_error_string.restype = ctypes.c_char_p
    return lib


def mel_frames(x, n_frames, cfg: MelConfig):
    """Normalised-dB mel rows of the first ``n_frames`` frames of a padded
    signal ``x`` -> (n_frames, n_mels) float32 on x's device. CUDA tensors
    launch the kernel; CPU tensors take `mel_frames_plain`. Raises on
    anything the kernel does not take and on any CUDA error."""
    global launches
    c = mel_consts(cfg, x.device)
    _check(x, n_frames, c)
    dev = x.device
    if dev.type == "cpu":
        return mel_frames_plain(x, n_frames, c)
    if dev.type != "cuda":
        raise ValueError(f"mel_spectrogram runs on cuda or cpu tensors, not {dev}")
    lib = _library()
    with torch.cuda.device(dev):
        out = torch.empty((n_frames, c.n_mels), dtype=torch.float32, device=dev)
        err = lib.zeggs_mel_spectrogram(
            x.data_ptr(), n_frames, c.window.data_ptr(), c.twiddle.data_ptr(),
            c.basis.data_ptr(), c.support.data_ptr(), out.data_ptr(), c.n_fft, c.hop,
            c.n_mels, c.amp_scale, c.min_amp, c.dyn_range, int(c.normalize),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mel_spectrogram kernel failed: CUDA error {err} "
                           f"({lib.zeggs_mel_error_string(err).decode()})")
    launches += 1
    return out
