"""BVH writing with root baking, BVH retargeting, blend ranges and
hyperparameter flattening (counterpart of `zeggs_tpu/utils/__init__.py`);
`metrics` holds the training metric writers, `logs` the loggers, the
console progress line and tables, and `profiling` the trace and timing
helpers."""

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


def _host(fn, *args, **kw):
    """``fn`` on float32 host tensors made from numpy arrays -> numpy."""
    return fn(*(torch.as_tensor(np.asarray(a, np.float32)) for a in args), **kw).numpy()


def change_bvh(filename, savename, order=None, fps=None, pace=1.0, center=False):
    """Retarget a BVH file: rotation order, frame rate and pace (cubic
    resampling of positions and unrolled quaternions), and optionally
    re-centre the root at the origin, facing as the first frame's heading.
    The quaternion math runs in float32 on the host."""
    from scipy.interpolate import griddata

    anim = bvh.load(filename)
    output = dict(anim)

    def quats(euler_deg, euler_order):
        return _host(lambda e: quat.unroll(quat.from_euler(e, euler_order)), np.radians(euler_deg))

    if order is not None:
        output["order"] = order
        output["rotations"] = np.degrees(
            _host(quat.to_euler, quats(anim["rotations"], anim["order"]), order=order))

    if pace is not None or fps is not None:
        if fps is None:
            fps = 1.0 / anim["frametime"]
        positions = anim["positions"]
        rots = quats(anim["rotations"], anim["order"])
        nframes, nbones = positions.shape[:2]
        t_orig = np.linspace(0, nframes - 1, nframes)
        t_new = np.linspace(0, nframes - 1, int(pace * (nframes * (fps * anim["frametime"]) - 1)))
        output["positions"] = griddata(
            t_orig, positions.reshape(nframes, -1), t_new, method="cubic"
        ).reshape(len(t_new), nbones, 3)
        rots = griddata(t_orig, rots.reshape(nframes, -1), t_new, method="cubic").reshape(
            len(t_new), nbones, 4)
        rots = _host(quat.normalize, rots)
        output["rotations"] = np.degrees(_host(quat.to_euler, rots, order=output["order"]))
        output["frametime"] = 1.0 / fps

    if center:
        lrot = _host(quat.from_euler, np.radians(output["rotations"]), order=output["order"])
        offset_pos = output["positions"][0:1, 0:1].copy() * np.array([1, 0, 1])
        offset_rot = lrot[0:1, 0:1].copy() * np.array([1, 0, 1, 0])
        inv_offset = _host(quat.inv, offset_rot)
        output["positions"] = np.asarray(output["positions"]).copy()
        output["positions"][:, 0:1] = _host(quat.mul_vec, inv_offset,
                                            output["positions"][:, 0:1] - offset_pos)
        output["rotations"] = np.asarray(output["rotations"]).copy()
        output["rotations"][:, 0:1] = np.degrees(_host(
            quat.to_euler, _host(quat.mul, inv_offset, lrot[:, 0:1]), order=output["order"]))

    bvh.save(savename, output)
