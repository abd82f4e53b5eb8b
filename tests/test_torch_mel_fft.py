"""The mel kernel's FFT plan (`fft_plan`), its launch shape and its
schedule, on the CPU.

The kernel cannot run here, so its arithmetic is held through a plain
PyTorch simulation of the planned schedule, driven by the plan's float32
tables: two frames packed as z = a + i b, the Stockham stages (natural
order in and out), the split into the two spectra, and the mel product
over the compact filters. It equals `torch.fft.rfft` within float32
round-off (1e-5 of the frame's norm) and, at n_fft 800, zeggs_tpu's Pallas
mel kernel (interpret mode, as tests/test_pallas_kernels.py runs it)
within that kernel's budget of 2e-4 on the normalised dB rows.
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
from zeggs_tpu_torch.ops.kernels import mel as K
from tests.synthetic import make_audio

N_FFTS = [800, 1024, 400, 802, 101, 810]
CPU = torch.device("cpu")


def _roots(r):
    q = np.arange(r)
    return torch.as_tensor(np.exp(-2j * np.pi * np.outer(q, q) / r).astype(np.complex64))


def _generic(v, roots):
    """The kernel's generic stage on twiddled inputs v (P, R, M): outputs q
    and R - q from the same four real sums over r."""
    r = v.shape[1]
    out = torch.empty(v.shape[0], r, v.shape[2], dtype=v.dtype)
    for q in range(r // 2 + 1):
        w = roots[(torch.arange(r) * q) % r]
        P, Q, U, V = (torch.einsum("prm,r->pm", a, b) for a, b in
                      ((v.real, w.real), (v.imag, w.imag), (v.real, w.imag), (v.imag, w.real)))
        out[:, q] = torch.complex(P - Q, U + V)
        if q:
            out[:, r - q] = torch.complex(P + Q, V - U)
    return out


def _fft(z, plan):
    """The kernel's stages on rows of z (P, n) complex64, with the plan's
    twiddles; the butterflies are R-point DFTs with float32 roots, the
    generic stages as the kernel sums them."""
    n = plan.n
    tw = torch.complex(*torch.as_tensor(plan.twiddles).unbind(1))
    for r, off, ns in zip(plan.radices, plan.offsets, plan.strides):
        m = n // r
        j = torch.arange(m)
        k = j % ns
        v = torch.stack([z[:, j + q * m] for q in range(r)], 1)  # (P, R, M)
        for q in range(1, r):
            v[:, q] *= tw[off + (q - 1) * ns + k]
        if r in K.BUTTERFLIES:
            vq = torch.einsum("qr,prm->pqm", _roots(r), v)
        else:  # with the R roots that follow the stage's twiddles
            vq = _generic(v, tw[off + (r - 1) * ns + torch.arange(r)])
        out = torch.empty_like(z)
        d = (j - k) * r + k
        for q in range(r):
            out[:, d + q * ns] = vq[:, q]
        z = out
    return z


def _simulate_spectra(frames, plan):
    """(T, n) float32 windowed frames -> (T, n/2 + 1) complex64 spectra, two
    frames a complex FFT; an odd count pairs the last frame with zeros."""
    T, n = frames.shape
    if T % 2:
        frames = torch.cat([frames, torch.zeros(1, n)])
    z = _fft(torch.complex(frames[0::2], frames[1::2]), plan)
    zc = torch.conj(z[:, (-torch.arange(n)) % n])[:, : n // 2 + 1]
    z = z[:, : n // 2 + 1]
    a, b = (z + zc) / 2, (z - zc) / 2j
    return torch.stack([a, b], 1).reshape(-1, n // 2 + 1)[:T]


def _simulate_mel(x, n_frames, c):
    """The kernel's rows: its spectra, then the mel product over each
    filter's nonzero bins from the compact filters, clip, dB, normalise."""
    frames = x.unfold(0, c.n_fft, c.hop)[:n_frames] * c.window
    amp = torch.abs(_simulate_spectra(frames, c.plan)) * c.amp_scale
    mel = torch.zeros(n_frames, c.n_mels)
    for m, (lo, hi) in enumerate(c.support.tolist()):
        mel[:, m] = amp[:, lo:hi] @ c.filters[m, : hi - lo]
    db = 20.0 * torch.log10(torch.clamp(mel.abs(), min=c.min_amp))
    return (db + c.dyn_range) / c.dyn_range if c.normalize else db


@pytest.mark.parametrize("n", N_FFTS)
def test_plan_factors_n_fft(n):
    plan = K.fft_plan(n)
    assert math.prod(plan.radices) == n
    specialised = [r for r in plan.radices if r in K.BUTTERFLIES]
    assert specialised == sorted(specialised, key=K.BUTTERFLIES.index)
    generic = plan.radices[len(specialised):]
    assert all(all(g % p for p in range(2, int(g**0.5) + 1)) for g in generic), "generic are primes"
    sizes = [(r - 1) * ns + (0 if r in K.BUTTERFLIES else r)
             for r, ns in zip(plan.radices, plan.strides)]
    assert list(plan.offsets) == list(np.cumsum([0] + sizes[:-1]))
    assert plan.twiddles.shape == (sum(sizes), 2) and plan.twiddles.dtype == np.float32


def test_plan_radices_of_known_sizes():
    assert K.fft_plan(800).radices == (4, 4, 2, 5, 5)
    assert K.fft_plan(802).radices == (2, 401)
    assert K.fft_plan(101).radices == (101,)
    assert K.fft_plan(810).radices == (2, 5, 3, 3, 3, 3)
    assert K.fft_plan(1024).radices == (4,) * 5


@pytest.mark.parametrize("n", N_FFTS)
def test_plan_twiddles_are_float64_rounded_once(n):
    plan = K.fft_plan(n)
    for r, off, ns in zip(plan.radices, plan.offsets, plan.strides):
        q, k = np.meshgrid(np.arange(1, r), np.arange(ns), indexing="ij")
        ang = -2 * np.pi * (q * k).ravel() / (ns * r)
        if r not in K.BUTTERFLIES:
            ang = np.concatenate([ang, -2 * np.pi * np.arange(r) / r])
        want = np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
        np.testing.assert_array_equal(plan.twiddles[off : off + len(ang)], want)


@pytest.mark.parametrize("frames", [1, 2, 3])
@pytest.mark.parametrize("n", N_FFTS)
def test_planned_schedule_equals_rfft(n, frames):
    rng = np.random.default_rng(n + frames)
    x = torch.as_tensor(rng.normal(size=(frames, n)).astype(np.float32))
    ours = _simulate_spectra(x, K.fft_plan(n))
    ref = torch.fft.rfft(x, dim=-1)
    assert ours.shape == ref.shape
    err = (ours - ref).abs().amax(-1) / torch.linalg.norm(x, dim=-1)
    assert err.max().item() <= 1e-5


def test_planned_schedule_equals_pallas_mel_kernel():
    x = make_audio(1.5, seed=2)
    cfg = jmel.MelConfig(normalize_loudness=False)
    ref = np.asarray(fused_mel_spectrogram(jnp.asarray(x), cfg))
    padded = TF.pad(torch.as_tensor(x)[None, None], (400, 400), mode="reflect")[0, 0]
    c = K.mel_consts(TC.MelConfig(normalize_loudness=False), CPU)
    ours = _simulate_mel(padded, ref.shape[0], c).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=0)
    # an odd count pairs the last frame with zeros and drops its row
    np.testing.assert_allclose(_simulate_mel(padded, 7, c).numpy(), ref[:7], atol=2e-4, rtol=0)


@pytest.mark.parametrize("n_fft", [800, 1024, 802])
def test_compact_filters_hold_the_filterbank(n_fft):
    cfg = TC.MelConfig(filter_length=n_fft, hop_length=n_fft // 4)
    c = K.mel_consts(cfg, CPU)
    assert c.filters.shape[1] == int((c.support[:, 1] - c.support[:, 0]).max())
    rebuilt = torch.zeros_like(c.basis)
    for m, (lo, hi) in enumerate(c.support.tolist()):
        rebuilt[m, lo:hi] = c.filters[m, : hi - lo]
        assert not c.filters[m, hi - lo :].any()
    torch.testing.assert_close(rebuilt, c.basis, atol=0, rtol=0)
    assert c.stages.tolist() == [list(s) for s in zip(c.plan.radices, c.plan.offsets)]


@pytest.mark.parametrize("frames,groups,blocks", [(1, 1, 1), (2, 1, 1), (32, 1, 16), (33, 1, 17),
                                                  (525, 1, 263), (527, 2, 132), (800, 2, 200),
                                                  (801, 2, 201), (4800, 2, 1200)])
def test_launch_shape_spreads_frame_pairs_over_the_sms(frames, groups, blocks):
    assert K.launch_shape(frames, sms=132) == (groups, blocks)
    assert groups * blocks * 2 >= frames > (groups * blocks - groups) * 2
    assert 1 <= groups <= K.MAX_GROUPS
