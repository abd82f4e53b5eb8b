"""BVH comparison (counterpart of `zeggs_tpu/cli/compare.py`, with the same
flags plus ``--device``): channel and joint-position error between two
animations, the joint positions by forward kinematics on the device.

Usage:
  python -m zeggs_tpu_torch.cli.compare ref.bvh test.bvh [--json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import require_device
from ..io import bvh
from ..ops import fk, quat


def compare_bvh(ref_path, test_path, device="cuda"):
    """-> dict of error statistics; ``comparable`` is false, with the two
    frame counts, when the animations differ in shape."""
    a, b = bvh.load(ref_path), bvh.load(test_path)
    if a["rotations"].shape != b["rotations"].shape:
        return {
            "comparable": False,
            "ref_frames": int(a["rotations"].shape[0]),
            "test_frames": int(b["rotations"].shape[0]),
        }
    dev = require_device(device)
    rot_mae = float(np.abs(a["rotations"] - b["rotations"]).mean())
    pos_mae = float(np.abs(a["positions"] - b["positions"]).mean())

    def global_positions(anim):
        q = quat.from_euler(torch.as_tensor(np.radians(anim["rotations"]), device=dev),
                            anim["order"])
        return fk.fk(q, torch.as_tensor(anim["positions"], device=dev), anim["parents"])[1]

    jpe = torch.linalg.norm(global_positions(a) - global_positions(b), dim=-1).cpu().numpy()
    return {
        "comparable": True,
        "frames": int(a["rotations"].shape[0]),
        "rotation_mae_deg": rot_mae,
        "position_mae": pos_mae,
        "joint_position_error_mean": float(jpe.mean()),
        "joint_position_error_max": float(jpe.max()),
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="zeggs_tpu_torch.compare")
    p.add_argument("ref")
    p.add_argument("test")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    result = compare_bvh(args.ref, args.test, args.device)
    if args.json:
        print(json.dumps(result))
    else:
        for k, v in result.items():
            print(f"{k}: {v}")
    return result


if __name__ == "__main__":
    main()
