"""Quaternion algebra on torch tensors (counterpart of `zeggs_tpu/ops/quat.py`).

Quaternions are (w, x, y, z) in the last axis; every function broadcasts
over leading dims and runs on the tensors' own device.
"""

from __future__ import annotations

import math

import torch


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def eye(shape=(), dtype=torch.float32, device=None):
    """Identity quaternion broadcast to ``shape + (4,)``."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device).expand(
        tuple(shape) + (4,))


def mul(x, y):
    """Hamilton product x*y."""
    x0, x1, x2, x3 = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
    y0, y1, y2, y3 = y[..., 0:1], y[..., 1:2], y[..., 2:3], y[..., 3:4]
    return torch.cat(
        [
            y0 * x0 - y1 * x1 - y2 * x2 - y3 * x3,
            y0 * x1 + y1 * x0 - y2 * x3 + y3 * x2,
            y0 * x2 + y1 * x3 + y2 * x0 - y3 * x1,
            y0 * x3 - y1 * x2 + y2 * x1 + y3 * x0,
        ],
        dim=-1,
    )


def mul_vec(q, v):
    """Rotate vector(s) v by quaternion(s) q."""
    t = 2.0 * _cross(q[..., 1:], v)
    return v + q[..., 0:1] * t + _cross(q[..., 1:], t)


def inv(x):
    """Conjugate (the inverse of a unit quaternion). Negates the vector part
    on the device, with no host-to-device copy of a sign vector: the
    decoder step calls this, and a CUDA graph captures that step."""
    return torch.cat([x[..., :1], -x[..., 1:]], dim=-1)


def inv_mul(x, y):
    return mul(inv(x), y)


def inv_mul_vec(q, v):
    return mul_vec(inv(q), v)


def diff(x, y, world=True):
    """Rotation taking y to x, sign-aligned."""
    d = torch.sum(x * y, dim=-1, keepdim=True)
    flip = torch.where(d > 0.0, x, -x)
    return mul(flip, inv(y)) if world else mul(inv(y), flip)


def abs_(x):
    """Force the hemisphere with non-negative w."""
    return torch.where(x[..., 0:1] > 0.0, x, -x)


def normalize(x, eps=0.0):
    """x / (|x| + eps)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True)) + eps)


def log(x, eps=1e-5):
    """Log map -> half-angle vector, scale snapped to 1 when |xyz| < eps."""
    length = torch.sqrt(torch.sum(x[..., 1:] * x[..., 1:], dim=-1, keepdim=True))
    small = length < eps
    safe = torch.where(small, torch.ones_like(length), length)
    halfangle = torch.where(
        small, torch.ones_like(length), torch.atan2(length, x[..., 0:1]) / safe
    )
    return halfangle * x[..., 1:]


def exp(x, eps=1e-5):
    """Exp map from a half-angle vector, with the small-angle branch
    normalize([1, x]) below eps (zeggs_tpu/ops/quat.py:98-112)."""
    halfangle = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    big = torch.cat([torch.cos(halfangle), x * torch.sinc(halfangle / math.pi)], dim=-1)
    tiny = normalize(torch.cat([torch.ones_like(halfangle), x], dim=-1), eps=eps)
    return torch.where(halfangle < eps, tiny, big)


def exp_np_style(x, eps=1e-5):
    """The numpy reference's exp: the small-angle branch is [1, x], not
    normalised."""
    halfangle = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    small = halfangle < eps
    c = torch.where(small, torch.ones_like(halfangle), torch.cos(halfangle))
    s = torch.where(small, torch.ones_like(halfangle), torch.sinc(halfangle / math.pi))
    return torch.cat([c, s * x], dim=-1)


def to_helical(x, eps=1e-5):
    return 2.0 * log(x, eps)


def from_helical(x, eps=1e-5):
    return exp(x / 2.0, eps)


def to_angle_axis(x, eps=1e-10):
    length = torch.sqrt(torch.sum(x[..., 1:] * x[..., 1:], dim=-1))
    angle = 2.0 * torch.atan2(length, x[..., 0])
    return angle, x[..., 1:] / (length[..., None] + eps)


def from_angle_axis(angle, axis):
    c = torch.cos(angle / 2.0)[..., None]
    s = torch.sin(angle / 2.0)[..., None]
    return torch.cat([c, s * axis], dim=-1)


def between(x, y):
    """Quaternion rotating direction x to direction y."""
    w = (
        torch.sqrt(torch.sum(x * x, dim=-1) * torch.sum(y * y, dim=-1))[..., None]
        + torch.sum(x * y, dim=-1)[..., None]
    )
    return torch.cat([w, _cross(x, y)], dim=-1)


def slerp(x, y, a, eps=1e-10):
    """Spherical interpolation from x (a = 0) to y (a = 1)."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    dot = torch.sum(x * y, dim=-1)
    o = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    a0 = torch.sin((1.0 - a) * o) / (torch.sin(o) + eps)
    a1 = torch.sin(a * o) / (torch.sin(o) + eps)
    return a0[..., None] * x + a1[..., None] * y


def mul_scalar(x, y):
    """Scale a rotation by the factor y: slerp from the identity."""
    return slerp(eye(x.shape[:-1], dtype=x.dtype, device=x.device), x, y)


def to_euler(x, order="zyx"):
    """Quaternion -> Euler angles (radians). ``xzy`` keeps the reference's
    convention, which is not the inverse of ``from_euler('xzy')``."""
    x0, x1, x2, x3 = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
    if order == "zyx":
        return torch.cat(
            [
                torch.atan2(2.0 * (x0 * x3 + x1 * x2), 1.0 - 2.0 * (x2 * x2 + x3 * x3)),
                torch.asin(torch.clamp(2.0 * (x0 * x2 - x3 * x1), -1.0, 1.0)),
                torch.atan2(2.0 * (x0 * x1 + x2 * x3), 1.0 - 2.0 * (x1 * x1 + x2 * x2)),
            ],
            dim=-1,
        )
    if order == "xzy":
        return torch.cat(
            [
                torch.atan2(2.0 * (x1 * x0 - x2 * x3), -x1 * x1 + x2 * x2 - x3 * x3 + x0 * x0),
                torch.atan2(2.0 * (x2 * x0 - x1 * x3), x1 * x1 - x2 * x2 - x3 * x3 + x0 * x0),
                torch.asin(torch.clamp(2.0 * (x1 * x2 + x3 * x0), -1.0, 1.0)),
            ],
            dim=-1,
        )
    raise NotImplementedError(f"Cannot convert to ordering {order}")


_AXIS = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0), "z": (0.0, 0.0, 1.0)}


def from_euler(e, order="zyx"):
    """Euler angles (radians) -> quaternion."""
    q = [from_angle_axis(e[..., i], e.new_tensor(_AXIS[order[i]])) for i in range(3)]
    return mul(q[0], mul(q[1], q[2]))


def to_xform(x):
    """Quaternion -> 3x3 rotation matrix."""
    qw, qx, qy, qz = x[..., 0:1], x[..., 1:2], x[..., 2:3], x[..., 3:4]
    x2, y2, z2 = qx + qx, qy + qy, qz + qz
    xx, yy, wx = qx * x2, qy * y2, qw * x2
    xy, yz, wy = qx * y2, qy * z2, qw * y2
    xz, zz, wz = qx * z2, qz * z2, qw * z2
    return torch.stack(
        [
            torch.cat([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1),
            torch.cat([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1),
            torch.cat([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def to_xy(x):
    """Quaternion -> the first two columns of its rotation matrix, (..., 3, 2)
    (the "rot6d" representation)."""
    return to_xform(x)[..., :2]


def from_xform(ts, eps=1e-10):
    """3x3 rotation matrix -> quaternion, four-branch select."""
    t = ts[..., 0, 0] + ts[..., 1, 1] + ts[..., 2, 2]

    s = 0.5 / torch.sqrt(torch.clamp(t + 1, min=eps))
    q_w = torch.stack(
        [
            0.25 / s,
            s * (ts[..., 2, 1] - ts[..., 1, 2]),
            s * (ts[..., 0, 2] - ts[..., 2, 0]),
            s * (ts[..., 1, 0] - ts[..., 0, 1]),
        ],
        dim=-1,
    )
    s0 = 2.0 * torch.sqrt(torch.clamp(1.0 + ts[..., 0, 0] - ts[..., 1, 1] - ts[..., 2, 2], min=eps))
    q_x = torch.stack(
        [
            (ts[..., 2, 1] - ts[..., 1, 2]) / s0,
            s0 * 0.25,
            (ts[..., 0, 1] + ts[..., 1, 0]) / s0,
            (ts[..., 0, 2] + ts[..., 2, 0]) / s0,
        ],
        dim=-1,
    )
    s1 = 2.0 * torch.sqrt(torch.clamp(1.0 + ts[..., 1, 1] - ts[..., 0, 0] - ts[..., 2, 2], min=eps))
    q_y = torch.stack(
        [
            (ts[..., 0, 2] - ts[..., 2, 0]) / s1,
            (ts[..., 0, 1] + ts[..., 1, 0]) / s1,
            s1 * 0.25,
            (ts[..., 1, 2] + ts[..., 2, 1]) / s1,
        ],
        dim=-1,
    )
    s2 = 2.0 * torch.sqrt(torch.clamp(1.0 + ts[..., 2, 2] - ts[..., 0, 0] - ts[..., 1, 1], min=eps))
    q_z = torch.stack(
        [
            (ts[..., 1, 0] - ts[..., 0, 1]) / s2,
            (ts[..., 0, 2] + ts[..., 2, 0]) / s2,
            (ts[..., 1, 2] + ts[..., 2, 1]) / s2,
            s2 * 0.25,
        ],
        dim=-1,
    )
    c0 = (ts[..., 0, 0] > ts[..., 1, 1]) & (ts[..., 0, 0] > ts[..., 2, 2])
    c1 = (~c0) & (ts[..., 1, 1] > ts[..., 2, 2])
    c2 = (~c0) & (~c1)
    pos = t > 0
    qs = torch.where(pos[..., None], q_w, torch.zeros_like(q_w))
    qs = torch.where((~pos & c0)[..., None], q_x, qs)
    qs = torch.where((~pos & c1)[..., None], q_y, qs)
    return torch.where((~pos & c2)[..., None], q_z, qs)


def unroll(x, axis=0):
    """Hemisphere-align a quaternion track over its time axis ``axis``:
    frame t flips exactly when its dot product with the aligned frame t-1
    is negative. A loop over frames, vectorised over the other axes (a
    stack of clips' tracks runs in one loop)."""
    x = x.movedim(axis, 0)
    out = [x[0]]
    for t in range(1, x.shape[0]):
        d = torch.sum(x[t] * out[-1], dim=-1, keepdim=True)
        out.append(torch.where(d < 0.0, -x[t], x[t]))
    return torch.stack(out, dim=axis)
