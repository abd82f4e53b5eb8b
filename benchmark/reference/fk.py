"""A frozen copy of `zeggs_tpu_torch/ops/fk.py` for the benchmark's plain reference.

Forward kinematics over a joint tree (counterpart of `zeggs_tpu/ops/fk.py`).

The walk over joints is a Python loop over the static parent list; every
step is vectorised over the leading (time, batch) axes. Joint axis is -2
for vectors and quaternions, -3 for matrices.
"""

from __future__ import annotations

import torch

from . import quat


def fk(lrot, lpos, parents):
    """Local -> global rotations and positions."""
    parents = [int(p) for p in parents]
    gp = [lpos[..., :1, :]]
    gr = [lrot[..., :1, :]]
    for i in range(1, len(parents)):
        p = parents[i]
        gp.append(quat.mul_vec(gr[p], lpos[..., i : i + 1, :]) + gp[p])
        gr.append(quat.mul(gr[p], lrot[..., i : i + 1, :]))
    return torch.cat(gr, dim=-2), torch.cat(gp, dim=-2)


def fk_vel(lrot, lpos, lvrt, lvel, parents):
    """FK with angular and linear velocity propagation:
    gv_i = gv_p + R_p v_i + (gt_p x R_p x_i);  gt_i = gt_p + R_p w_i."""
    parents = [int(p) for p in parents]
    gp = [lpos[..., :1, :]]
    gr = [lrot[..., :1, :]]
    gt = [lvrt[..., :1, :]]
    gv = [lvel[..., :1, :]]
    for i in range(1, len(parents)):
        p = parents[i]
        rp = gr[p]
        xi = quat.mul_vec(rp, lpos[..., i : i + 1, :])
        gp.append(xi + gp[p])
        gr.append(quat.mul(rp, lrot[..., i : i + 1, :]))
        gt.append(gt[p] + quat.mul_vec(rp, lvrt[..., i : i + 1, :]))
        gv.append(
            gv[p] + quat.mul_vec(rp, lvel[..., i : i + 1, :])
            + torch.linalg.cross(gt[p], xi, dim=-1)
        )
    return (
        torch.cat(gr, dim=-2),
        torch.cat(gp, dim=-2),
        torch.cat(gt, dim=-2),
        torch.cat(gv, dim=-2),
    )


def ik_rot(grot, parents):
    """Global -> local rotations."""
    parents = [int(p) for p in parents]
    lr = [grot[..., :1, :]]
    for i in range(1, len(parents)):
        p = parents[i]
        lr.append(quat.mul(quat.inv(grot[..., p : p + 1, :]), grot[..., i : i + 1, :]))
    return torch.cat(lr, dim=-2)


def fk_root_position(gpos, grot, lpos, parents):
    """Global positions from global rotations and the root's position."""
    parents = [int(p) for p in parents]
    gp = [gpos[..., :1, :]]
    for i in range(1, len(parents)):
        p = parents[i]
        gp.append(quat.mul_vec(grot[..., p : p + 1, :], lpos[..., i : i + 1, :]) + gp[p])
    return torch.cat(gp, dim=-2)


def mat3_mul(a, b):
    """(..., 3, 3) @ (..., 3, 3) as a broadcast multiply and a sum, the
    reference's order of terms."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def mat3_vec(a, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return torch.sum(a * v[..., None, :], dim=-1)


def xform_fk_vel(lxform, lpos, lvrt, lvel, parents):
    """Matrix-form FK with velocities: local rotation matrices (..., J, 3, 3)
    -> (global matrices, positions, angular and linear velocities), the
    training loss's FK on orthogonalised rot6d predictions."""
    parents = [int(p) for p in parents]
    gr = [lxform[..., :1, :, :]]
    gp = [lpos[..., :1, :]]
    gt = [lvrt[..., :1, :]]
    gv = [lvel[..., :1, :]]
    for i in range(1, len(parents)):
        p = parents[i]
        rp = gr[p]
        xi = mat3_vec(rp, lpos[..., i : i + 1, :])
        gp.append(gp[p] + xi)
        gr.append(mat3_mul(rp, lxform[..., i : i + 1, :, :]))
        gt.append(gt[p] + mat3_vec(rp, lvrt[..., i : i + 1, :]))
        gv.append(gv[p] + mat3_vec(rp, lvel[..., i : i + 1, :])
                  + torch.linalg.cross(gt[p], xi, dim=-1))
    return (
        torch.cat(gr, dim=-3),
        torch.cat(gp, dim=-2),
        torch.cat(gt, dim=-2),
        torch.cat(gv, dim=-2),
    )
