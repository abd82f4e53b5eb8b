"""The features of ZEGGS in plain PyTorch and numpy: a frozen copy of
`zeggs_tpu_torch/data/features.py`'s animation featurizer and of
`ops/mel.py`'s audio front end, with the mel kernel replaced by its plain
version (`ops/kernels/mel.py::mel_frames_plain`): symmetric-Hann STFT
magnitude / n_fft -> Slaney mel filterbank -> clip -> dB -> [0, 1] range ->
10**(x/20) then ln -> linear resample to 60 fps, plus an energy channel.
Loudness normalisation (BS.1770) runs on the host, as in the port.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import fk, quat
from .loudness import normalize_loudness


@dataclasses.dataclass
class AnimFeatures:
    """Output of `extract_anim_features`: (T, ...) float32 tensors."""

    root_pos: torch.Tensor
    root_rot: torch.Tensor
    root_vel: torch.Tensor
    root_vrt: torch.Tensor
    lpos: torch.Tensor
    lrot: torch.Tensor
    ltxy: torch.Tensor
    lvel: torch.Tensor
    lvrt: torch.Tensor
    cpos: torch.Tensor
    crot: torch.Tensor
    ctxy: torch.Tensor
    cvel: torch.Tensor
    cvrt: torch.Tensor
    gaze_pos: torch.Tensor
    gaze_dir: torch.Tensor


def _extrapolate_frame0(v):
    return torch.cat([(v[1] - (v[3] - v[2]))[None], v[1:]], dim=0)


def _finite_diff(x, dt):
    d = (x[1:] - x[:-1]) / dt
    return _extrapolate_frame0(torch.cat([torch.zeros_like(d[:1]), d], dim=0))


def _rot_diff_helical(q, dt):
    d = quat.to_helical(quat.abs_(quat.mul(q[1:], quat.inv(q[:-1])))) / dt
    return _extrapolate_frame0(torch.cat([torch.zeros_like(d[:1]), d], dim=0))


def _median_time(x):
    """Median over axis 0; an even count averages the two middle values,
    as numpy and jnp.median do (torch.median would take the lower one)."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def extract_anim_features(rotations_deg, positions, parents, names, dt, order="zyx",
                          gaze_distance=100.0, device="cpu"):
    """Animation featurizer from the BVH fields: rotations in degrees
    (T, J, 3), positions (T, J, 3), on ``device``."""
    i_spine2, i_hips, i_head = names.index("Spine2"), names.index("Hips"), names.index("Head")
    f32 = torch.float32
    rot = torch.as_tensor(np.asarray(rotations_deg, np.float32), device=device)
    lpos = torch.as_tensor(np.asarray(positions, np.float32), device=device)
    ground = torch.tensor([1.0, 0.0, 1.0], dtype=f32, device=device)
    fwd = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=device)

    lrot = quat.unroll(quat.from_euler(torch.deg2rad(rot), order))
    grot, gpos = fk.fk(lrot, lpos, parents)

    root_pos = gpos[:, i_spine2] * ground
    root_fwd = quat.mul_vec(grot[:, i_hips], fwd[None]) * ground
    root_fwd = root_fwd / torch.sqrt(torch.sum(root_fwd * root_fwd, dim=-1))[..., None]
    root_rot = quat.normalize(quat.between(fwd[None].expand_as(root_fwd), root_fwd))

    lookat = quat.mul_vec(grot[:, i_head], fwd) * ground
    lookat = lookat / torch.sqrt(torch.sum(lookat * lookat, dim=-1))[..., None]
    gaze_pos_all = root_pos + gaze_distance * lookat
    gaze_pos = _median_time(gaze_pos_all).expand_as(root_pos)
    gaze_dir = quat.mul_vec(quat.inv(root_rot), gaze_pos - root_pos)

    # joint 0 re-expressed in the root frame
    lrot = lrot.clone()
    lpos = lpos.clone()
    lrot[:, 0] = quat.mul(quat.inv(root_rot), lrot[:, 0])
    lpos[:, 0] = quat.mul_vec(quat.inv(root_rot), lpos[:, 0] - root_pos)

    lvel = _finite_diff(lpos, dt)
    lvrt = _rot_diff_helical(lrot, dt)

    # root velocities: world-space differences rotated into the previous
    # frame's root space (frame 0 uses its own)
    prev_rot = torch.cat([root_rot[:1], root_rot[:-1]], dim=0)
    root_vrt = quat.mul_vec(quat.inv(prev_rot), _rot_diff_helical(root_rot, dt))
    root_vel = quat.mul_vec(quat.inv(prev_rot), _finite_diff(root_pos, dt))

    crot, cpos, cvrt, cvel = fk.fk_vel(lrot, lpos, lvrt, lvel, parents)
    unit_x = torch.tensor([1.0, 0.0, 0.0], dtype=f32, device=device)
    unit_y = torch.tensor([0.0, 1.0, 0.0], dtype=f32, device=device)
    ltxy = torch.stack([quat.mul_vec(lrot, unit_x), quat.mul_vec(lrot, unit_y)], dim=-2)
    ctxy = torch.stack([quat.mul_vec(crot, unit_x), quat.mul_vec(crot, unit_y)], dim=-2)
    return AnimFeatures(root_pos, root_rot, root_vel, root_vrt, lpos, lrot, ltxy, lvel, lvrt,
                        cpos, crot, ctxy, cvel, cvrt, gaze_pos, gaze_dir)


def preprocess_animation(anim_data, gaze_distance=100.0, device="cpu"):
    """Featurize a BVH dict as returned by `io.bvh.load`."""
    return extract_anim_features(
        anim_data["rotations"], anim_data["positions"],
        [int(p) for p in np.asarray(anim_data["parents"])], list(anim_data["names"]),
        float(anim_data["frametime"]), order=anim_data["order"],
        gaze_distance=gaze_distance, device=device,
    )


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


def num_frames(n_padded, n_fft, step_size):
    """Frames of a padded signal of ``n_padded`` samples, the reference's
    convention: one frame fewer than a plain sliding window when the padded
    length is a multiple of the hop."""
    frames = (n_padded - n_fft) // step_size
    return frames if n_padded % step_size == 0 else frames + 1


def linear_resample(y, t_new, extrapolate=False):
    """Linear interpolation of (T, C) rows at fractional indices ``t_new``;
    ``extrapolate=False`` clamps to the hull."""
    T = y.shape[0]
    if not extrapolate:
        t_new = torch.clamp(t_new, 0.0, T - 1.0)
    i0 = torch.clamp(torch.floor(t_new).to(torch.int64), 0, T - 2)
    frac = (t_new - i0).reshape((-1,) + (1,) * (y.ndim - 1))
    return y[i0] * (1.0 - frac) + y[i0 + 1] * frac




def mel_db(x, cfg):
    """Normalised-dB mel rows of a 1-D float32 signal (T, n_mels): the
    port's padding, then the plain STFT-to-dB chain."""
    n_fft, hop = cfg["filter_length"], cfg["hop_length"]
    if x.shape[0] < n_fft:
        x = F.pad(x, (0, n_fft - x.shape[0]))
    if cfg["centered"]:
        pad = n_fft // 2
        x = F.pad(x[None, None], (pad, pad), mode="reflect")[0, 0]
    T = num_frames(x.shape[0], n_fft, hop)
    basis = torch.as_tensor(mel_filterbank(n_fft, cfg["sampling_rate"], cfg["n_mel_channels"],
                                           cfg["mel_fmin"], cfg["mel_fmax"],
                                           cfg["normalize_mel_bins"]), device=x.device)
    window = torch.as_tensor(hann_symmetric(n_fft), device=x.device)
    amp_scale = 1.0 / n_fft if cfg["real_amplitude"] else 1.0
    min_amp = cfg["min_clipping"] * amp_scale
    dyn_range = -20.0 * math.log10(min_amp)
    windowed = x.unfold(0, n_fft, hop)[:T] * window
    amp = torch.abs(torch.fft.rfft(windowed, dim=-1)) * amp_scale
    mel = torch.clamp(torch.abs(amp @ basis.T), min=min_amp)
    db = 20.0 * torch.log10(mel)
    return (db + dyn_range) / dyn_range if cfg["normalize_range"] else db


def audio_features(audio, anim_fs, anim_length, cfg, normalize=None, device="cpu"):
    """Samples (numpy float32) -> (anim_length, n_mels + 1) features:
    log-mel and energy on the 60 fps grid. ``normalize`` (default: the
    configuration's ``normalize_loudness``) scales the clip to -20 LUFS
    first."""
    audio = np.asarray(audio, np.float32)
    if cfg["normalize_loudness"] if normalize is None else normalize:
        audio = normalize_loudness(audio, cfg["sampling_rate"], -20.0)
    x = torch.as_tensor(audio, device=device)
    mel = 10.0 ** (mel_db(x, cfg) / 20.0)
    log_mel = torch.log(mel)
    step = (cfg["sampling_rate"] / cfg["hop_length"]) / anim_fs
    t_new = step * torch.arange(anim_length, device=x.device, dtype=torch.float32)
    energy = torch.linalg.norm(mel, dim=-1)
    return torch.cat([linear_resample(log_mel, t_new, extrapolate=False),
                      linear_resample(energy[:, None], t_new, extrapolate=True)], dim=-1)
