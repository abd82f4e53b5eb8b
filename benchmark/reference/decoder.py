"""The ``normal`` decoder of ZEGGS in plain PyTorch: a frozen copy of the
parameter layout of `zeggs_tpu_torch/models/decoder.py` and of its plain
differentiable step (`chunk_step` where autograd records), with no kernel,
no CUDA graph and no int8 path.

A cell-state encoder sets the two GRU layers' hidden state from (frame-0
pose, style); then each frame runs vectorize_input -> Linear+ELU skip into
GRU0 -> GRU1 -> Linear -> devectorize_output and feeds the integrated pose
back. The speech/style part of layer0's and GRU0's input products is one
product over all frames, as the port computes it.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import layers as L
from . import pose as P


class CellStateEncoder(nn.Module):
    def __init__(self, input_size, hidden_size, num_rnn_layers, device=None):
        super().__init__()
        self.l0 = nn.Linear(input_size, hidden_size, device=device)
        self.l1 = nn.Linear(hidden_size, hidden_size, device=device)
        self.l2 = nn.Linear(hidden_size, hidden_size * num_rnn_layers, device=device)


class NormalCell(nn.Module):
    def __init__(self, all_input, hidden_size, pose_output_size, device=None):
        super().__init__()
        self.layer0 = nn.Linear(all_input, hidden_size, device=device)
        self.gru0 = nn.GRUCell(all_input + hidden_size, hidden_size, device=device)
        self.gru1 = nn.GRUCell(hidden_size, hidden_size, device=device)
        self.out = nn.Linear(hidden_size, pose_output_size, device=device)


class Decoder(nn.Module):
    def __init__(self, pose_input_size, pose_output_size, speech_encoding_size,
                 style_encoding_size, hidden_size, num_rnn_layers=2, device=None):
        super().__init__()
        self.num_rnn_layers = num_rnn_layers
        self.cell_state_encoder = CellStateEncoder(
            pose_input_size + style_encoding_size, hidden_size, num_rnn_layers, device=device)
        all_input = pose_input_size + speech_encoding_size + style_encoding_size
        self.cell = NormalCell(all_input, hidden_size, pose_output_size, device=device)


def rollout(dec: Decoder, root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
            gaze_pos, speech_encoding, style_encoding, anim_input_mean, anim_input_std,
            anim_output_mean, anim_output_std, dt):
    """Autoregressive rollout from the frame-0 state (B, ...) under per-frame
    conditioning gaze_pos (B, T, 3), speech (B, T, S), style (B, T, C) ->
    the 8 trajectories (B, T, ...), frame 0 equal to the inputs."""
    cse, cp = dec.cell_state_encoder, dec.cell
    pose0 = P.vectorize_input(root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
                              gaze_pos[:, 0], anim_input_mean, anim_input_std)
    h = L.elu(L.linear(torch.cat([pose0, style_encoding[:, 0]], dim=-1), cse.l0))
    h = L.elu(L.linear(h, cse.l1))
    h = L.linear(h, cse.l2).reshape(pose0.shape[0], dec.num_rnn_layers, -1).transpose(0, 1)
    h0, h1 = h[0], h[1].contiguous()

    pose_dim = anim_input_mean.shape[-1]
    H = cp.gru1.weight_hh.shape[1]
    njoints = lpos.shape[1]
    w0, wg = cp.layer0.weight, cp.gru0.weight_ih
    w0_pose, wg_h, wg_pose = w0[:, :pose_dim], wg[:, :H], wg[:, H : H + pose_dim]
    cond = torch.cat([speech_encoding[:, 1:], style_encoding[:, 1:]], dim=-1)
    pre_l0 = F.linear(cond, w0[:, pose_dim:], cp.layer0.bias)
    pre_g0 = F.linear(cond, wg[:, H + pose_dim :], cp.gru0.bias_ih)

    state = (root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt)
    frames = [state]
    for t in range(speech_encoding.shape[1] - 1):
        pose = P.vectorize_input(*state, gaze_pos[:, t + 1], anim_input_mean, anim_input_std)
        hidden = L.elu(pre_l0[:, t] + pose @ w0_pose.T)
        gi = pre_g0[:, t] + hidden @ wg_h.T + pose @ wg_pose.T
        h0 = L.gru_gates(gi, F.linear(h0, cp.gru0.weight_hh, cp.gru0.bias_hh), h0)
        h1 = L.gru_gates(F.linear(h0, cp.gru1.weight_ih, cp.gru1.bias_ih),
                         F.linear(h1, cp.gru1.weight_hh, cp.gru1.bias_hh), h1)
        out = F.linear(h1, cp.out.weight, cp.out.bias)
        state = P.devectorize_output(out, state[0], state[1], njoints, dt, anim_output_mean,
                                     anim_output_std)
        frames.append(state)
    return tuple(torch.stack([f[i] for f in frames], dim=1) for i in range(8))
