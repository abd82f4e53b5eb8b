"""Rotation-matrix helpers (counterpart of `zeggs_tpu/ops/xform.py`): the
rot6d -> rotation-matrix step that BVH export needs."""

from __future__ import annotations

import torch


def transpose(xform):
    return torch.swapaxes(xform, -1, -2)


def orthogonalize_from_xy(xy, eps=1e-10):
    """(..., 2, 3) rows = images of the x and y axes -> (..., 3, 3) rotation
    whose columns are x̂, ŷ, ẑ."""
    xaxis = xy[..., 0:1, :]
    zaxis = torch.linalg.cross(xaxis, xy[..., 1:2, :], dim=-1)
    yaxis = torch.linalg.cross(zaxis, xaxis, dim=-1)
    rows = torch.cat(
        [
            xaxis / (torch.linalg.norm(xaxis, dim=-1)[..., None] + eps),
            yaxis / (torch.linalg.norm(yaxis, dim=-1)[..., None] + eps),
            zaxis / (torch.linalg.norm(zaxis, dim=-1)[..., None] + eps),
        ],
        dim=-2,
    )
    return transpose(rows)
