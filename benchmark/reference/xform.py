"""A frozen copy of `zeggs_tpu_torch/ops/xform.py` for the benchmark's plain reference.

Rotation-matrix and homogeneous-transform helpers (counterpart of
`zeggs_tpu/ops/xform.py`). Every function broadcasts over leading batch
dims and runs on its tensors' device; products are full float32 (the JAX
package pins ``Precision.HIGHEST``; the port turns TF32 off in
`device.require_device`)."""

from __future__ import annotations

import torch


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


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


# -- dense matrix helpers ----------------------------------------------------

def mul(x, y):
    """Matrix product over the trailing two axes."""
    return torch.matmul(x, y)


def mul_vec(x, y):
    """(..., m, n) matrices applied to (..., n) vectors."""
    return torch.matmul(x, y[..., None])[..., 0]


def psolve(x, y, eps=1e-5):
    """Regularised pseudo-solve ``pinv(x) @ y``, transposed, batched over
    leading dims: under-determined (m < n) solves the Gram system on the n
    side, over-determined (m > n) on the m side, square adds eps**2 * I."""
    m, n = x.shape[-2], x.shape[-1]
    xt = transpose(x)
    if m < n:
        a = torch.matmul(xt, x) + (eps * eps) * torch.eye(n, dtype=x.dtype, device=x.device)
        return transpose(torch.linalg.solve(a, torch.matmul(xt, y)))
    if m > n:
        a = torch.matmul(x, xt) + (eps * eps) * torch.eye(m, dtype=x.dtype, device=x.device)
        return transpose(torch.matmul(xt, torch.linalg.solve(a, y)))
    a = x + (eps * eps) * torch.eye(m, dtype=x.dtype, device=x.device)
    return transpose(torch.linalg.solve(a, y))


# -- rotation matrices and homogeneous 4x4 transforms --------------------------

def to_translation(x):
    """Translation column of a homogeneous 4x4, divided by w."""
    return x[..., :3, 3] / x[..., 3, 3][..., None]


def to_rotation(x):
    """Upper-left 3x3 block."""
    return x[..., :3, :3]


def to_rotation_translation(x):
    return to_rotation(x), to_translation(x)


def from_rotation_translation(rot, pos):
    """(..., 3, 3) and (..., 3) -> homogeneous (..., 4, 4)."""
    top = torch.cat([rot, pos[..., None]], dim=-1)
    bottom = top.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(top[..., :1, :].shape)
    return torch.cat([top, bottom], dim=-2)


def to_angle_axis(x, eps=1e-10):
    """Rotation matrix -> (angle, axis). The cosine is clipped to [0, 1], as
    the reference clips it, so angles beyond pi/2 read as pi/2."""
    angle = torch.arccos(
        torch.clamp((x[..., 0, 0] + x[..., 1, 1] + x[..., 2, 2] - 1.0) / 2.0, 0.0, 1.0))
    axis = torch.stack(
        [x[..., 2, 1] - x[..., 1, 2], x[..., 0, 2] - x[..., 2, 0], x[..., 1, 0] - x[..., 0, 1]],
        dim=-1,
    ) / ((2.0 * torch.sin(angle))[..., None] + eps)
    return angle, axis


def from_angle_axis(angle, axis):
    """Rodrigues rotation matrix from (angle, unit axis)."""
    angle = angle[..., None]
    a0, a1, a2 = axis[..., 0:1], axis[..., 1:2], axis[..., 2:3]
    c, s = torch.cos(angle), torch.sin(angle)
    t = 1.0 - c
    r0 = torch.cat([c + a0 * a0 * t, a0 * a1 * t - a2 * s, a0 * a2 * t + a1 * s], dim=-1)
    r1 = torch.cat([a0 * a1 * t + a2 * s, c + a1 * a1 * t, a1 * a2 * t - a0 * s], dim=-1)
    r2 = torch.cat([a0 * a2 * t - a1 * s, a1 * a2 * t + a0 * s, c + a2 * a2 * t], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)


def log(x, eps=1e-10):
    """Half-angle-scaled axis of a rotation matrix."""
    angle, axis = to_angle_axis(x, eps=eps)
    return (angle / 2.0)[..., None] * axis


def exp(x, eps=1e-10):
    """Inverse of `log`."""
    halfangle = torch.sqrt(torch.sum(x**2.0, dim=-1))
    axis = x[..., :3] / (halfangle[..., None] + eps)
    return from_angle_axis(2.0 * halfangle, axis)


def from_basis(x, y, z):
    """Columns x, y, z -> (..., 3, 3)."""
    return torch.stack([x, y, z], dim=-1)


def from_euler(e, order="zyx"):
    """Euler angles (..., 3) -> rotation matrix, for the six axis orders."""
    c, s = torch.cos(e), torch.sin(e)
    c0, c1, c2 = c[..., 0], c[..., 1], c[..., 2]
    s0, s1, s2 = s[..., 0], s[..., 1], s[..., 2]
    if order == "xzy":
        rows = [[c1 * c2, -s1, c1 * s2],
                [s0 * s2 + c0 * c2 * s1, c0 * c1, c0 * s1 * s2 - c2 * s0],
                [c2 * s0 * s1 - c0 * s2, c1 * s0, c0 * c2 + s0 * s1 * s2]]
    elif order == "xyz":
        rows = [[c1 * c2, -c1 * s2, s1],
                [c0 * s2 + c2 * s0 * s1, c0 * c2 - s0 * s1 * s2, -c1 * s0],
                [s0 * s2 - c0 * c2 * s1, c2 * s0 + c0 * s1 * s2, c0 * c1]]
    elif order == "yxz":
        rows = [[c0 * c2 + s0 * s1 * s2, c2 * s0 * s1 - c0 * s2, c1 * s0],
                [c1 * s2, c1 * c2, -s1],
                [c0 * s1 * s2 - c2 * s0, c0 * c2 * s1 + s0 * s2, c0 * c1]]
    elif order == "yzx":
        rows = [[c0 * c1, s0 * s2 - c0 * c2 * s1, c2 * s0 + c0 * s1 * s2],
                [s1, c1 * c2, -c1 * s2],
                [-c1 * s0, c0 * s2 + c2 * s0 * s1, c0 * c2 - s0 * s1 * s2]]
    elif order == "zyx":
        rows = [[c0 * c1, c0 * s1 * s2 - c2 * s0, s0 * s2 + c0 * c2 * s1],
                [c1 * s0, c0 * c2 + s0 * s1 * s2, c2 * s0 * s1 - c0 * s2],
                [-s1, c1 * s2, c1 * c2]]
    elif order == "zxy":
        rows = [[c0 * c2 - s0 * s1 * s2, -c1 * s0, c0 * s2 + c2 * s0 * s1],
                [c2 * s0 + c0 * s1 * s2, c0 * c1, s0 * s2 - c0 * c2 * s1],
                [-c1 * s2, s1, c1 * c2]]
    else:
        raise ValueError(f"Unknown ordering: {order}")
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def orthogonalize(x, method="svd", eps=0.0):
    """Project an approximate rotation onto SO(3). ``"cross"`` is the
    reference's Gram-Schmidt by cross products; ``"svd"`` the polar
    projection U @ Vt with the reflection case flipped to det +1."""
    if method == "cross":
        r0, r1 = x[..., 0], x[..., 1]
        r2 = torch.linalg.cross(r0, r1, dim=-1)
        r0 = r0 / (torch.linalg.norm(r0, dim=-1)[..., None] + eps)
        r2 = r2 / (torch.linalg.norm(r2, dim=-1)[..., None] + eps)
        r1 = torch.linalg.cross(r2, r0, dim=-1)
        return from_basis(r0, r1, r2)
    if method == "svd":
        u, _, vt = torch.linalg.svd(x)
        det = torch.linalg.det(torch.matmul(u, vt))
        u = torch.cat([u[..., :, :-1], u[..., :, -1:] * torch.sign(det)[..., None, None]], dim=-1)
        return torch.matmul(u, vt)
    raise ValueError(f"Unknown method '{method}'")


def orthogonalize_iterative(ts, R=None, iterations=4, eps=1e-5):
    """Iterative projection onto SO(3): each sweep rotates R by the net
    torque of its columns toward the target's."""
    if R is None:
        R = torch.eye(3, dtype=ts.dtype, device=ts.device).expand(ts.shape)
    for _ in range(iterations):
        torque = (_cross(R[..., :, 0], ts[..., :, 0]) + _cross(R[..., :, 1], ts[..., :, 1])
                  + _cross(R[..., :, 2], ts[..., :, 2]))
        align = torch.abs(
            torch.sum(R[..., :, 0] * ts[..., :, 0], dim=-1)
            + torch.sum(R[..., :, 1] * ts[..., :, 1], dim=-1)
            + torch.sum(R[..., :, 2] * ts[..., :, 2], dim=-1)
        )[..., None]
        omega = torque / (align + eps)
        w = torch.linalg.norm(omega, dim=-1)
        R = torch.matmul(from_angle_axis(w, omega / (w[..., None] + eps)), R)
    return R
