"""The comparison of served or written frames with the plain reference, for
the inference cells.

The reference (`benchmark/reference/model.py::infer`) runs each sampled
request at float32 with TF32 off, from the same WAV, the same first-pose or
style clip and the same seed; the frames are compared as the BVH holds
them, re-anchored with the root baked into joint 0 (`bvh_pose`):

  * ``rot_gap``: the widest gap of any entry of any joint's rotation
    matrix (dimensionless, at most 2), the Euler angles of a BVH turned
    back into matrices by the reference's own conversion;
  * ``pos_gap``: the widest gap of the root's position (cm).

The control computes the reference's side with TF32 products
(`reference/precision.py`) in the program's place.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import bvh, model
from .reference.precision import precision


def gaps(prog_pose, ref_pose):
    """(rot_gap, pos_gap) of two (root position (T, 3), rotations (T, J, 3, 3))
    poses; a length mismatch is a gap of infinity."""
    (pp, pr), (rp, rr) = prog_pose, ref_pose
    if pp.shape != rp.shape or pr.shape != rr.shape:
        return float("inf"), float("inf")
    out = float((pr - rr).abs().max()), float((pp - rp).abs().max())
    return tuple(v if np.isfinite(v) else float("inf") for v in out)


def bvh_text_pose(text, names):
    """The pose a BVH's text holds, its joints in the order of ``names``
    (a file lists them depth first)."""
    return model.parsed_bvh_pose(bvh.loads(text), names)


def reference_poses(cfg, params, stats, jobs, device, tf32=False):
    """The reference's BVH poses of ``jobs`` (dicts of `model.infer`'s
    keyword arguments), products in TF32 with ``tf32``."""
    with precision(tf32):
        nets = model.load(model.build_networks(cfg, device), params)
        s = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
             for k, v in stats.items()}
        dt = 1.0 / cfg["dataset"]["fps"]
        return [model.bvh_pose(model.infer(cfg, nets, s, dt, device=device, **job))
                for job in jobs]


def worst(pairs):
    """{rot_gap, pos_gap}: the widest over (program pose, reference pose)
    pairs."""
    all_gaps = [gaps(p, r) for p, r in pairs] or [(float("inf"), float("inf"))]
    return {"rot_gap": max(g[0] for g in all_gaps), "pos_gap": max(g[1] for g in all_gaps)}
