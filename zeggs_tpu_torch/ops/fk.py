"""Forward kinematics over a joint tree (counterpart of `zeggs_tpu/ops/fk.py`).

The walk over joints is a Python loop over the static parent list; every
step is vectorised over the leading (time, batch) axes. Joint axis is -2.
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
