"""BVH writing with root baking, blend ranges and hyperparameter flattening
(counterpart of `zeggs_tpu/utils/__init__.py`); `metrics` holds the
training metric writers and `logs` the console progress line and tables."""

from __future__ import annotations

import numpy as np
import torch

from ..io import bvh
from ..ops import quat


def write_bvh(filename, root_pos, root_rot, lpos, lrot, parents, names, order="zyx",
              dt=1.0 / 60.0, start_position=None, start_rotation=None):
    """Write a model-space animation (host arrays or tensors, (T, ...)) to
    BVH: optionally re-anchor the trajectory to (start_position,
    start_rotation), bake the root transform into joint 0 and convert the
    rotations to Euler degrees. The math runs in float32 on the host."""

    def host(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    root_pos, root_rot = host(root_pos), host(root_rot)
    lpos, lrot = host(lpos).clone(), host(lrot).clone()
    if start_position is not None and start_rotation is not None:
        offset_pos, offset_rot = root_pos[0:1].clone(), root_rot[0:1].clone()
        start_position, start_rotation = host(start_position), host(start_rotation)
        root_pos = quat.mul_vec(quat.inv(offset_rot), root_pos - offset_pos)
        root_rot = quat.mul(quat.inv(offset_rot), root_rot)
        root_pos = quat.mul_vec(start_rotation[None], root_pos) + start_position[None]
        root_rot = quat.mul(start_rotation[None], root_rot)

    lpos[:, 0] = quat.mul_vec(root_rot, lpos[:, 0]) + root_pos
    lrot[:, 0] = quat.mul(root_rot, lrot[:, 0])
    bvh.save(
        filename,
        dict(
            order=order,
            offsets=lpos[0].numpy(),
            names=list(names),
            frametime=dt,
            parents=np.asarray(parents),
            positions=lpos.numpy(),
            rotations=torch.rad2deg(quat.to_euler(lrot, order=order)).numpy(),
        ),
    )


def split_by_ratio(length, ratio):
    """Contiguous index ranges proportional to ``ratio``."""
    assert abs(sum(ratio) - 1.0) < 1e-9
    splits = []
    end = 0.0
    prev = 0
    for r in ratio:
        end += r * length
        splits.append([prev, int(end)])
        prev = int(end)
    splits[-1][-1] = length
    return splits


def flatten_dict(dd, separator="_", prefix=""):
    """Flatten nested dicts for hyperparameter logging."""
    if not isinstance(dd, dict):
        return {prefix: dd}
    out = {}
    for kk, vv in dd.items():
        key = prefix + separator + kk if prefix else kk
        out.update(flatten_dict(vv, separator, key))
    return out
