"""Fused STFT magnitude + mel filterbank + dB: the CUDA kernel
(csrc/mel_spectrogram.cu), its FFT plan and constants, its plain PyTorch
version and its launch count.

Replaces `zeggs_tpu/ops/pallas/mel_kernel.py::fused_mel_spectrogram`. The
core takes a signal that is already padded (and pre-emphasised) and a frame
count T, and returns (T, n_mels): frame t is x[t*hop : t*hop + n_fft] times
the symmetric Hann window, then |rFFT| * amp_scale, the mel filterbank,
clip at min_amp, 20 log10 and, with ``normalize_range``, (db + dyn) / dyn.
`ops/mel.py::mel_spectrogram_tts` pads a clip and calls the core; the
streaming front end calls it on each ready window of samples.

The kernel computes the rFFT of two frames at once, as one complex FFT of
``a + i b`` through the mixed-radix Stockham stages of `fft_plan`, a group
of 8 warps per frame pair. Constants are made once per (config, device)
with the numpy functions the JAX package uses; twiddles are computed in
float64 and rounded to float32 once.
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

#: radices with a butterfly of their own in the kernel, in the order the
#: plan takes them; any other prime factor is one generic stage
BUTTERFLIES = (4, 2, 5, 3)
#: frame pairs a block at most; the kernel gives each pair a group of 8 warps
MAX_GROUPS = 2


@dataclasses.dataclass(frozen=True)
class FftPlan:
    """The kernel's schedule for an n-point complex FFT: Stockham stages
    (natural order in and out, no bit reversal), one per radix. Stage s has
    radix R and follows stages whose radices multiply to Ns; its twiddles
    start at ``offsets[s]``: exp(-2 pi i r k / (Ns R)) at (r - 1) Ns + k
    for 1 <= r < R, k < Ns, then, for a generic radix, the R roots
    exp(-2 pi i t / R)."""

    n: int
    radices: tuple
    offsets: tuple
    twiddles: np.ndarray  # (L, 2) float32 re, im

    @property
    def strides(self):
        """Ns of each stage: the product of the radices before it."""
        return tuple(math.prod(self.radices[:s]) for s in range(len(self.radices)))


def _factor(n):
    """Radices of n: fours, then twos, fives and threes, then each other
    prime factor in ascending order."""
    radices = []
    for r in BUTTERFLIES:
        while n % r == 0:
            radices.append(r)
            n //= r
    p = 7
    while n > 1:
        if p * p > n:
            p = n
        while n % p == 0:
            radices.append(p)
            n //= p
        p += 2
    return tuple(radices)


@functools.lru_cache(maxsize=16)
def fft_plan(n) -> FftPlan:
    """The stages and twiddles of an n-point complex FFT, for any n >= 1."""
    if n < 1:
        raise ValueError(f"an FFT needs n >= 1, got {n}")
    radices = _factor(n)
    angles, offsets, ns, at = [], [], 1, 0
    for r in radices:
        ang = [np.outer(np.arange(1, r), np.arange(ns)).ravel() / (ns * r)]
        if r not in BUTTERFLIES:
            ang.append(np.arange(r) / r)
        a = -2.0 * np.pi * np.concatenate(ang)
        angles.append(a)
        offsets.append(at)
        at += a.size
        ns *= r
    a = np.concatenate(angles) if angles else np.zeros(0)
    tw = np.stack([np.cos(a), np.sin(a)], 1).astype(np.float32)
    return FftPlan(n, radices, tuple(offsets), tw)


@dataclasses.dataclass(frozen=True)
class MelConsts:
    """A `MelConfig`'s constants on one device."""

    window: torch.Tensor  # (n_fft,) symmetric Hann
    plan: FftPlan
    stages: torch.Tensor  # (n_stages, 2) int32: radix, offset of its twiddles
    twiddles: torch.Tensor  # the plan's (L, 2) float32 twiddles
    basis: torch.Tensor  # (n_mels, n_bins) mel filterbank
    support: torch.Tensor  # (n_mels, 2) int32 [first, last + 1) nonzero bin of each filter
    filters: torch.Tensor  # (n_mels, width) each filter's weights from its first nonzero bin
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
    width = max(1, int((last - first).max()))
    filters = np.zeros((basis.shape[0], width), np.float32)
    for m, (lo, hi) in enumerate(zip(first, last)):
        filters[m, : hi - lo] = basis[m, lo:hi]
    plan = fft_plan(n_fft)
    min_amp = cfg.min_clipping / (n_fft if cfg.real_amplitude else 1)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return MelConsts(
        window=dev(hann_symmetric(n_fft)),
        plan=plan,
        stages=dev(np.asarray([plan.radices, plan.offsets], np.int32).T.reshape(-1, 2)),
        twiddles=dev(plan.twiddles),
        basis=dev(basis),
        support=dev(np.stack([first, last], 1).astype(np.int32)),
        filters=dev(filters),
        n_fft=n_fft, hop=cfg.hop_length,
        amp_scale=1.0 / n_fft if cfg.real_amplitude else 1.0,
        min_amp=min_amp, dyn_range=-20.0 * math.log10(min_amp),
        normalize=cfg.normalize_range,
    )


def launch_shape(n_frames, sms):
    """(groups a block, blocks) for ``n_frames`` frames on a card of ``sms``
    SMs: a group per frame pair, one group a block while there are fewer
    pairs than two an SM (a 32-frame window takes 16 SMs), then
    `MAX_GROUPS` (800 frames take 200 blocks), so that long clips stage the
    tables fewer times. The launch in csrc/mel_spectrogram.cu takes fewer
    groups where a block of these would not fit the card's shared memory,
    and fails where one group does not."""
    pairs = (n_frames + 1) // 2
    groups = max(1, min(MAX_GROUPS, pairs // sms))
    return groups, -(-pairs // groups)


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
    lib.zeggs_mel_spectrogram.argtypes = ([p, i, p, p, p, i, p, i, p, p, i, i, i]
                                          + [f, f, f, i, i, i, p])
    lib.zeggs_mel_spectrogram.restype = i
    lib.zeggs_mel_error_string.argtypes = [i]
    lib.zeggs_mel_error_string.restype = ctypes.c_char_p
    return lib


def _raise_for(err):
    if err != 0:
        raise RuntimeError(f"mel_spectrogram kernel failed: CUDA error {err} "
                           f"({_library().zeggs_mel_error_string(err).decode()})")


def mel_frames(x, n_frames, cfg: MelConfig):
    """Normalised-dB mel rows of the first ``n_frames`` frames of a padded
    signal ``x`` -> (n_frames, n_mels) float32 on x's device. CUDA tensors
    launch the kernel in `launch_shape`'s shape; CPU tensors take
    `mel_frames_plain`. Raises on anything the kernel does not take and on
    any CUDA error."""
    c = mel_consts(cfg, x.device)
    _check(x, n_frames, c)
    dev = x.device
    if dev.type == "cpu":
        return mel_frames_plain(x, n_frames, c)
    if dev.type != "cuda":
        raise ValueError(f"mel_spectrogram runs on cuda or cpu tensors, not {dev}")
    return _launch(x, n_frames, c, launch_shape(n_frames, _sm_count(dev.index))[0])


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(x, n_frames, c: MelConsts, groups):
    """Launch the kernel on a checked CUDA tensor ``x`` with at most
    ``groups`` frame pairs a block; `mel_frames` picks ``groups``, a timing
    script may force it."""
    global launches
    with torch.cuda.device(x.device):
        out = torch.empty((n_frames, c.n_mels), dtype=torch.float32, device=x.device)
        err = _library().zeggs_mel_spectrogram(
            x.data_ptr(), n_frames, c.window.data_ptr(), c.stages.data_ptr(),
            c.twiddles.data_ptr(), c.twiddles.shape[0], c.filters.data_ptr(),
            c.filters.shape[1], c.support.data_ptr(), out.data_ptr(), c.n_fft, c.hop, c.n_mels,
            c.amp_scale, c.min_amp, c.dyn_range, int(c.normalize), len(c.plan.radices),
            groups, torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_for(err)
    launches += 1
    return out
