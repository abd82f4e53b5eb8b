"""A frozen copy of `zeggs_tpu_torch/train/loss.py` for the benchmark's plain reference.

The ZeroEGGS training loss: 17 weighted L1 terms + the annealed KL
(counterpart of `zeggs_tpu/train/loss.py`).

As in the reference:
  * the world-space velocity re-expression rotates frame t's root-space
    velocity by frame t-1's root rotation (frame 0 by its own), and the same
    shifted convention feeds joint 0's update;
  * the gaze term normalises the gaze offset, which the decoder input does
    not;
  * the KL weight follows a generalised logistic curve in the iteration,
    capped at 0.2.
"""

from __future__ import annotations

import torch

from . import fk, quat, xform


def _normalize(x, eps=1e-8):
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)


def _shifted_world_vel(root_rot, vec):
    """Rotate per-frame root-space vectors into world space by the previous
    frame's rotation (frame 0 by its own)."""
    v0 = quat.mul_vec(root_rot[:, 0:1], vec[:, 0:1])
    v1 = quat.mul_vec(root_rot[:, :-1], vec[:, 1:])
    return torch.cat([v0, v1], dim=1)


def world_space_reexpression(root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt):
    """(lmat, lpos, lvel, lvrt, world root_vel, world root_vrt) with joint 0
    re-expressed in world space."""
    lmat = xform.orthogonalize_from_xy(ltxy)
    root_vel_w = _shifted_world_vel(root_rot, root_vel)
    root_vrt_w = _shifted_world_vel(root_rot, root_vrt)

    l0_pos = quat.mul_vec(root_rot, lpos[:, :, 0]) + root_pos
    l0_mat = fk.mat3_mul(quat.to_xform(root_rot), lmat[:, :, 0])
    l0_vel = (
        root_vel_w
        + quat.mul_vec(root_rot, lvel[:, :, 0])
        + torch.linalg.cross(root_vrt_w, quat.mul_vec(root_rot, lpos[:, :, 0]), dim=-1)
    )
    l0_vrt = root_vrt_w + quat.mul_vec(root_rot, lvrt[:, :, 0])

    lpos = torch.cat([l0_pos[:, :, None], lpos[:, :, 1:]], dim=2)
    lmat = torch.cat([l0_mat[:, :, None], lmat[:, :, 1:]], dim=2)
    lvel = torch.cat([l0_vel[:, :, None], lvel[:, :, 1:]], dim=2)
    lvrt = torch.cat([l0_vrt[:, :, None], lvrt[:, :, 1:]], dim=2)
    return lmat, lpos, lvel, lvrt, root_vel_w, root_vrt_w


def generalized_logistic_function(x, center=0.0, growth=1.0, lower=0.0, upper=1.0, c=1.0,
                                  q=1.0, nu=1.0):
    """Richards curve of a float32 tensor x."""
    return lower + (upper - lower) / (c + q * torch.exp(-growth * (x - center))) ** (1.0 / nu)


def kl_divergence(mu, logvar, iteration, center=7500.0, growth=0.005, cap=0.2):
    """VAE KL and its annealed weight -> (kl, weight). ``iteration`` is a
    number, or a float32 tensor on mu's device (a captured train step reads
    it from a buffer: no host copy)."""
    kl = torch.mean(-0.5 * torch.mean(1 + logvar - mu**2 - torch.exp(logvar), dim=1))
    if torch.is_tensor(iteration):
        x = iteration.to(torch.float32)
    else:
        x = torch.tensor(float(iteration), dtype=torch.float32, device=mu.device)
    w = generalized_logistic_function(x, center=center, growth=growth)
    return kl, torch.clamp(w, max=cap)


# term weights
WEIGHTS = dict(
    root_pos=0.1, root_rot=10.0, root_vel=0.1, root_vrt=5.0,
    lpos=15.0, lrot=15.0, lvel=10.0, lvrt=7.0,
    cpos=0.1, crot=3.0, cvel=0.06, cvrt=1.25,
    ldvl=7.0, ldvt=8.0, cdvl=0.06, cdvt=1.25,
    gaze=10.0,
)


def _l1(w, a, b):
    return torch.mean(torch.abs(w * (a - b)))


def _dv(w, a, b, dt):
    return torch.mean(torch.abs(w * ((a[:, 1:] - a[:, :-1]) / dt - (b[:, 1:] - b[:, :-1]) / dt)))


def compute_loss(outputs, targets, gaze_pos, parents, dt, mu=None, logvar=None, iteration=0):
    """Full training loss.

    outputs / targets: dicts with keys root_pos, root_rot, root_vel,
    root_vrt, lpos, ltxy, lvel, lvrt, each (B, T, ...); gaze_pos (B, T, 3)
    is the ground-truth gaze, used for both sides; ``iteration`` as in
    `kl_divergence`. Returns (loss, metrics),
    the metrics the 18 terms and ``total_loss`` as 0-d tensors."""
    O, W = outputs, targets
    o_lmat, o_lpos, o_lvel, o_lvrt, o_rvel_w, o_rvrt_w = world_space_reexpression(
        O["root_pos"], O["root_rot"], O["root_vel"], O["root_vrt"],
        O["lpos"], O["ltxy"], O["lvel"], O["lvrt"],
    )
    w_lmat, w_lpos, w_lvel, w_lvrt, w_rvel_w, w_rvrt_w = world_space_reexpression(
        W["root_pos"], W["root_rot"], W["root_vel"], W["root_vrt"],
        W["lpos"], W["ltxy"], W["lvel"], W["lvrt"],
    )
    w_cmat, w_cpos, w_cvrt, w_cvel = fk.xform_fk_vel(w_lmat, w_lpos, w_lvrt, w_lvel, parents)
    o_cmat, o_cpos, o_cvrt, o_cvel = fk.xform_fk_vel(o_lmat, o_lpos, o_lvrt, o_lvel, parents)

    o_root_mat = quat.to_xform(O["root_rot"])
    w_root_mat = quat.to_xform(W["root_rot"])
    w_gaze_dir = quat.inv_mul_vec(W["root_rot"], _normalize(gaze_pos - W["root_pos"]))
    o_gaze_dir = quat.inv_mul_vec(O["root_rot"], _normalize(gaze_pos - O["root_pos"]))

    w = WEIGHTS
    m = {
        "loss_root_pos": _l1(w["root_pos"], O["root_pos"], W["root_pos"]),
        "loss_root_rot": _l1(w["root_rot"], o_root_mat, w_root_mat),
        "loss_root_vel": _l1(w["root_vel"], o_rvel_w, w_rvel_w),
        "loss_root_vrt": _l1(w["root_vrt"], o_rvrt_w, w_rvrt_w),
        "loss_lpos": _l1(w["lpos"], o_lpos, w_lpos),
        "loss_lrot": _l1(w["lrot"], O["ltxy"], W["ltxy"]),
        "loss_lvel": _l1(w["lvel"], o_lvel, w_lvel),
        "loss_lvrt": _l1(w["lvrt"], o_lvrt, w_lvrt),
        "loss_cpos": _l1(w["cpos"], o_cpos, w_cpos),
        "loss_crot": _l1(w["crot"], o_cmat, w_cmat),
        "loss_cvel": _l1(w["cvel"], o_cvel, w_cvel),
        "loss_cvrt": _l1(w["cvrt"], o_cvrt, w_cvrt),
        "loss_ldvl": _dv(w["ldvl"], o_lpos, w_lpos, dt),
        "loss_ldvt": _dv(w["ldvt"], O["ltxy"], W["ltxy"], dt),
        "loss_cdvl": _dv(w["cdvl"], o_cpos, w_cpos, dt),
        "loss_cdvt": _dv(w["cdvt"], o_cmat, w_cmat, dt),
        "loss_gaze": _l1(w["gaze"], o_gaze_dir, w_gaze_dir),
    }
    if mu is not None and logvar is not None:
        kl, w_kl = kl_divergence(mu, logvar, iteration)
        m["loss_kl_div"] = w_kl * kl
    else:
        m["loss_kl_div"] = torch.zeros((), device=O["root_pos"].device)
    loss = sum(m.values()) / 18.0
    m["total_loss"] = loss
    return loss, m
