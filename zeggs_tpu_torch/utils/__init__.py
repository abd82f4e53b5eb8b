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
from . import profiling


def bvh_channels(root_pos, root_rot, lpos, lrot, reanchor=False, order="zyx"):
    """A model-space animation's BVH channels, over any leading dimensions
    and on the tensors' device: (..., T, 3) root_pos, (..., T, 4) root_rot,
    (..., T, J, 3) lpos and (..., T, J, 4) lrot in any float dtype ->
    (positions (..., T, J, 3), rotations (..., T, J, 3) as Euler degrees in
    ``order``), float32. The inputs are upcast first; quaternions that come
    in a reduced dtype are normalised after the upcast (rounded to float16,
    a unit quaternion's norm is off by up to ~1e-3, which the Euler
    conversion turns into degrees near gimbal lock). With ``reanchor``,
    frame 0's root is moved to the origin and the identity rotation; then
    the root transform is baked into joint 0."""
    reduced = torch.finfo(lrot.dtype).bits < 32
    root_pos, root_rot, lpos, lrot = (t.float() for t in (root_pos, root_rot, lpos, lrot))
    if reduced:
        root_rot, lrot = (q / torch.linalg.norm(q, dim=-1, keepdim=True) for q in (root_rot, lrot))
    if reanchor:
        back = quat.inv(root_rot[..., 0:1, :])
        root_pos = quat.mul_vec(back, root_pos - root_pos[..., 0:1, :])
        root_rot = quat.mul(back, root_rot)
    positions = torch.cat([(quat.mul_vec(root_rot, lpos[..., 0, :]) + root_pos)[..., None, :],
                           lpos[..., 1:, :]], dim=-2)
    rotations = torch.cat([quat.mul(root_rot, lrot[..., 0, :])[..., None, :],
                           lrot[..., 1:, :]], dim=-2)
    return positions, torch.rad2deg(quat.to_euler(rotations, order=order))


def save_channels(filename, positions, rotations, parents, names, order="zyx", dt=1.0 / 60.0):
    """Write one clip's BVH channels as they are, only formatted: host
    arrays (T, J, 3) of positions and of Euler degrees; the offsets are
    frame 0 of the positions."""
    bvh.save(filename, dict(order=order, offsets=positions[0], names=list(names), frametime=dt,
                            parents=np.asarray(parents), positions=positions,
                            rotations=rotations))


def write_bvh(filename, root_pos, root_rot, lpos, lrot, parents, names, order="zyx",
              dt=1.0 / 60.0, start_position=None, start_rotation=None):
    """Write a model-space animation (host arrays or tensors, (T, ...), in
    any float dtype) to BVH: its channels (`bvh_channels`) computed in
    float32 on the host. Given a start pose, which must be the origin and
    the identity rotation, frame 0 is re-anchored to it. Counts
    ``bvh.host_bakes``."""
    reanchor = start_position is not None and start_rotation is not None
    if reanchor and not (np.allclose(np.asarray(start_position), 0.0)
                         and np.allclose(np.asarray(start_rotation), [1.0, 0.0, 0.0, 0.0])):
        raise ValueError("write_bvh re-anchors to the origin and the identity rotation only")
    profiling.count("bvh.host_bakes")
    positions, rotations = bvh_channels(
        *(torch.as_tensor(x, device="cpu") for x in (root_pos, root_rot, lpos, lrot)),
        reanchor=reanchor, order=order)
    save_channels(filename, positions.numpy(), rotations.numpy(), parents, names, order, dt)


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
