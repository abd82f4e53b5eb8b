"""Per-clip featurizers (counterpart of `zeggs_tpu/data/features.py`).

Canonical frame: root = Spine2 projected on the ground; root rotation =
yaw of the Hips forward axis; gaze = the median horizontal look-at point
at 100 cm. Velocities are one-sided finite differences with the frame-0
extrapolation v[0] = v[1] - (v[3] - v[2]).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..audio.loudness import normalize_loudness as _normalize_loudness
from ..config import MelConfig
from ..ops import fk, mel, quat


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
    (T, J, 3), positions (T, J, 3). Runs on ``device``."""
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


def preprocess_audio(audio_data, anim_fs, anim_length, cfg: MelConfig,
                     feature_type=("mel_spec", "energy"), normalize_loudness=None,
                     device="cpu"):
    """Audio featurizer -> (anim_length, n_features) float32 on ``device``.
    Loudness normalisation (BS.1770, to -20 LUFS) runs on the host."""
    do_norm = cfg.normalize_loudness if normalize_loudness is None else normalize_loudness
    audio = np.asarray(audio_data, np.float32)
    if do_norm:
        audio = _normalize_loudness(audio, cfg.sampling_rate, -20.0)
    x = torch.as_tensor(audio, device=device)
    return mel.audio_features(x, anim_fs, anim_length, cfg, feature_type)
