"""Pose vector packing and root integration (counterpart of
`zeggs_tpu/models/pose.py`).

  input  (1134) = root_vel(3) | root_vrt(3) | lpos(J*3) | ltxy(J*2*3)
                  | lvel(J*3) | lvrt(J*3) | gaze_dir(3)
  output (1131) = the same without gaze_dir.
"""

from __future__ import annotations

import torch

from ..ops import quat


def vectorize_input(root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
                    gaze_pos, anim_input_mean, anim_input_std):
    """One frame of pose state -> normalised network input (B, pose_in).
    The gaze is the offset rotated into root space and left unnormalised,
    as in the reference."""
    b = lpos.shape[0]
    gaze_dir = quat.inv_mul_vec(root_rot, gaze_pos - root_pos)
    pose = torch.cat(
        [
            root_vel.reshape(b, -1), root_vrt.reshape(b, -1), lpos.reshape(b, -1),
            ltxy.reshape(b, -1), lvel.reshape(b, -1), lvrt.reshape(b, -1),
            gaze_dir.reshape(b, -1),
        ],
        dim=1,
    )
    return (pose - anim_input_mean) / anim_input_std


def devectorize_output(predicted, root_pos, root_rot, njoints, dt, anim_output_mean,
                       anim_output_std):
    """Denormalise the prediction, split it, and integrate the root:
    root_pos' = R(root_rot) v dt + root_pos;
    root_rot' = exp(R(root_rot) w dt / 2) * root_rot."""
    b = predicted.shape[0]
    p = predicted * anim_output_std + anim_output_mean
    root_vel = p[:, 0:3]
    root_vrt = p[:, 3:6]
    o = 6
    J = njoints
    lpos = p[:, o : o + J * 3].reshape(b, J, 3)
    ltxy = p[:, o + J * 3 : o + J * 9].reshape(b, J, 2, 3)
    lvel = p[:, o + J * 9 : o + J * 12].reshape(b, J, 3)
    lvrt = p[:, o + J * 12 : o + J * 15].reshape(b, J, 3)
    new_root_pos = quat.mul_vec(root_rot, root_vel * dt) + root_pos
    new_root_rot = quat.mul(quat.from_helical(quat.mul_vec(root_rot, root_vrt * dt)), root_rot)
    return new_root_pos, new_root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt


def example_feature_vec(root_vel, root_vrt, lpos, ltxy, lvel, lvrt):
    """Per-frame style-example features (T, pose_in) with a zero gaze slot."""
    t = root_vel.shape[0]
    return torch.cat(
        [
            root_vel.reshape(t, -1), root_vrt.reshape(t, -1), lpos.reshape(t, -1),
            ltxy.reshape(t, -1), lvel.reshape(t, -1), lvrt.reshape(t, -1),
            root_vel.new_zeros((t, 3)),
        ],
        dim=1,
    )
