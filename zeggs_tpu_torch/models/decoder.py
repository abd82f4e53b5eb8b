"""Autoregressive gesture decoder, ``normal`` cell (counterpart of
`zeggs_tpu/models/decoder.py`).

A cell-state encoder sets the two GRU layers' hidden state from (frame-0
pose, style); then each frame runs vectorize_input -> Linear+ELU -> GRU0
-> GRU1 -> Linear -> devectorize_output and feeds the integrated pose
back. `rollout_chunk` is an eager loop over frames with the speech/style
part of every per-frame product hoisted out of the loop as one product
over all frames, the plain counterpart of the reference's scan. GRU1 of
every step is one launch of the GRU-cell CUDA kernel
(`ops/kernels/gru_cell.py`) on a card, its plain version on the CPU;
``quantize_int8`` runs the step's products on int8 values instead.

At B=1 on a card `make_fused_b1_fn` runs the whole rollout as one launch
of the CUDA kernel in `ops/kernels/decoder_rollout.py`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.kernels import decoder_rollout as DR
from ..ops.kernels import gru_cell as GC
from . import layers as L
from . import pose as P


class CellStateEncoder(nn.Module):
    def __init__(self, input_size, hidden_size, num_rnn_layers, device=None):
        super().__init__()
        self.l0 = nn.Linear(input_size, hidden_size, device=device)
        self.l1 = nn.Linear(hidden_size, hidden_size, device=device)
        self.l2 = nn.Linear(hidden_size, hidden_size * num_rnn_layers, device=device)


class NormalCell(nn.Module):
    """Linear+ELU skip into a 2-layer GRU. The GRU0 input is
    [hidden | pose | speech | style]; layer0's is [pose | speech | style]."""

    def __init__(self, all_input, hidden_size, pose_output_size, device=None):
        super().__init__()
        self.layer0 = nn.Linear(all_input, hidden_size, device=device)
        self.gru0 = nn.GRUCell(all_input + hidden_size, hidden_size, device=device)
        self.gru1 = nn.GRUCell(hidden_size, hidden_size, device=device)
        self.out = nn.Linear(hidden_size, pose_output_size, device=device)


class Decoder(nn.Module):
    def __init__(self, pose_input_size, pose_output_size, speech_encoding_size,
                 style_encoding_size, hidden_size, num_rnn_layers=2, rnn_cond="normal",
                 device=None):
        super().__init__()
        if rnn_cond != "normal" or num_rnn_layers != 2:
            raise NotImplementedError(
                f"decoder cell {rnn_cond!r} with {num_rnn_layers} layers is not ported yet"
            )
        all_input = pose_input_size + speech_encoding_size + style_encoding_size
        self.num_rnn_layers = num_rnn_layers
        self.cell_state_encoder = CellStateEncoder(
            pose_input_size + style_encoding_size, hidden_size, num_rnn_layers, device=device
        )
        self.cell = NormalCell(all_input, hidden_size, pose_output_size, device=device)


def cell_state_encoder(cse: CellStateEncoder, pose, style, num_rnn_layers=2):
    """Initial GRU hidden state from (frame-0 pose input, style) ->
    (num_layers, B, H)."""
    h = L.elu(L.linear(torch.cat([pose, style], dim=-1), cse.l0))
    h = L.elu(L.linear(h, cse.l1))
    out = L.linear(h, cse.l2)
    return out.reshape(out.shape[0], num_rnn_layers, -1).transpose(0, 1)


def init_carry(dec: Decoder, root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
               gaze0, style0, anim_input_mean, anim_input_std):
    """Carry (GRU hidden (L, B, H), root_pos, root_rot, root_vel, root_vrt,
    lpos, ltxy, lvel, lvrt) from a frame-0 state and its conditioning."""
    pose0 = P.vectorize_input(root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
                              gaze0, anim_input_mean, anim_input_std)
    h0 = cell_state_encoder(dec.cell_state_encoder, pose0, style0, dec.num_rnn_layers)
    return (h0, root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt)


def _quantize_weight(w):
    """(out, in) weight -> int8 values as float32 and one scale per output
    row, with the batched path's floor of 1e-12 (an all-zero row keeps it)."""
    s = torch.clamp(w.abs().amax(dim=1), min=1e-12) / 127.0
    return torch.round(w / s[:, None]), s


def _quantize_act(x):
    """(B, K) activations -> int8 values as float32 and one scale per row."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    return torch.clamp(torch.round(x / s), -127.0, 127.0), s


def _qdot(xq_sx, wq_sw):
    """Product of quantized activations and weights, dequantized. int8
    values are kept in float32, where a sum of products is exact while it
    stays below 2^24 (torch.matmul has no int8 path on CUDA)."""
    (xq, sx), (wq, sw) = xq_sx, wq_sw
    return (xq @ wq.T) * (sx * sw)


def rollout_chunk(dec: Decoder, carry, gaze_pos, speech_encoding, style_encoding,
                  anim_input_mean, anim_input_std, anim_output_mean, anim_output_std, dt,
                  output_indices=None, quantize_int8=False):
    """Advance ``speech_encoding.shape[1]`` frames from ``carry``; each
    column of the (B, n, ...) conditioning is one step. Returns (new_carry,
    trajectories (B, n, ...)).

    quantize_int8 (inference): the in-step products run on symmetric int8
    weights with one scale per output row and activations quantized
    dynamically with one scale per batch row (floors 1e-12), as the JAX
    package's batched int8 path does; the speech/style projections stay
    float32."""
    cp = dec.cell
    njoints = carry[5].shape[1]
    pose_dim = anim_input_mean.shape[-1]
    H = cp.gru1.weight_hh.shape[1]

    w0 = cp.layer0.weight
    wg = cp.gru0.weight_ih
    w0_pose, wg_h, wg_pose = w0[:, :pose_dim], wg[:, :H], wg[:, H : H + pose_dim]
    # speech/style part of layer0 and of GRU0's input product, for all frames
    cond = torch.cat([speech_encoding, style_encoding], dim=-1)
    pre_l0 = torch.nn.functional.linear(cond, w0[:, pose_dim:], cp.layer0.bias)
    pre_g0 = torch.nn.functional.linear(cond, wg[:, H + pose_dim :], cp.gru0.bias_ih)

    if quantize_int8:
        q_w0_pose, q_wg_h, q_wg_pose = (_quantize_weight(w) for w in (w0_pose, wg_h, wg_pose))
        q_g0_whh, q_g1_wih, q_g1_whh, q_w_out = (
            _quantize_weight(w)
            for w in (cp.gru0.weight_hh, cp.gru1.weight_ih, cp.gru1.weight_hh, cp.out.weight)
        )
    else:
        gru1 = GC.pack_gru(cp.gru1)  # biases folded once per rollout, not per step

    h, rp, rr, rv, rw, jp, jt, jv, jw = carry
    h0, h1 = h[0], h[1].contiguous()  # the cell-state encoder's h is a transposed view
    emitted = []
    for t in range(speech_encoding.shape[1]):
        pose = P.vectorize_input(rp, rr, rv, rw, jp, jt, jv, jw, gaze_pos[:, t],
                                 anim_input_mean, anim_input_std)
        if quantize_int8:
            pose_q = _quantize_act(pose)
            hidden = L.elu(pre_l0[:, t] + _qdot(pose_q, q_w0_pose))
            gi = pre_g0[:, t] + _qdot(_quantize_act(hidden), q_wg_h) + _qdot(pose_q, q_wg_pose)
            gh = _qdot(_quantize_act(h0), q_g0_whh) + cp.gru0.bias_hh
            h0_new = L.gru_gates(gi, gh, h0)
            gi1 = _qdot(_quantize_act(h0_new), q_g1_wih) + cp.gru1.bias_ih
            gh1 = _qdot(_quantize_act(h1), q_g1_whh) + cp.gru1.bias_hh
            h0, h1 = h0_new, L.gru_gates(gi1, gh1, h1)
            out = _qdot(_quantize_act(h1), q_w_out) + cp.out.bias
        else:
            hidden = L.elu(pre_l0[:, t] + pose @ w0_pose.T)
            gi = pre_g0[:, t] + hidden @ wg_h.T + pose @ wg_pose.T
            gh = torch.nn.functional.linear(h0, cp.gru0.weight_hh, cp.gru0.bias_hh)
            h0 = L.gru_gates(gi, gh, h0)
            h1 = GC.fused_gru_cell(gru1, h0, h1)
            out = L.linear(h1, cp.out)
        new = P.devectorize_output(out, rp, rr, njoints, dt, anim_output_mean, anim_output_std)
        rp, rr, rv, rw, jp, jt, jv, jw = new
        emitted.append(new if output_indices is None else tuple(new[i] for i in output_indices))
    new_carry = (torch.stack([h0, h1]), rp, rr, rv, rw, jp, jt, jv, jw)
    n_out = 8 if output_indices is None else len(output_indices)
    if not emitted:
        ref = carry[1:] if output_indices is None else tuple(carry[1 + i] for i in output_indices)
        return new_carry, tuple(x[:, None][:, :0] for x in ref)
    return new_carry, tuple(torch.stack([e[i] for e in emitted], dim=1) for i in range(n_out))


def rollout(dec: Decoder, root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
            gaze_pos, speech_encoding, style_encoding, anim_input_mean, anim_input_std,
            anim_output_mean, anim_output_std, dt, output_indices=None, quantize_int8=False):
    """Autoregressive rollout from the frame-0 state (B, ...) under per-frame
    conditioning gaze_pos (B, T, 3), speech (B, T, S), style (B, T, C).
    Returns the 8 trajectories (B, T, ...), or those in ``output_indices``,
    with frame 0 equal to the inputs. ``quantize_int8``: see
    `rollout_chunk`."""
    carry0 = init_carry(dec, root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
                        gaze_pos[:, 0], style_encoding[:, 0], anim_input_mean, anim_input_std)
    _, ys = rollout_chunk(dec, carry0, gaze_pos[:, 1:], speech_encoding[:, 1:],
                          style_encoding[:, 1:], anim_input_mean, anim_input_std,
                          anim_output_mean, anim_output_std, dt, output_indices=output_indices,
                          quantize_int8=quantize_int8)
    firsts = (root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt)
    if output_indices is not None:
        firsts = tuple(firsts[i] for i in output_indices)
    return tuple(torch.cat([f[:, None], y], dim=1) for f, y in zip(firsts, ys))


def fused_b1_supported(dec: Decoder, rnn_cond="normal", num_rnn_layers=2,
                       weights_dtype=torch.bfloat16):
    """Whether the whole-rollout CUDA kernel can run this model: the
    ``normal`` 2-layer cell with a hidden size that is a multiple of 8, or
    of 16 with int8 weights (16-byte rows)."""
    H = dec.cell.gru1.weight_hh.shape[1]
    align = 16 if weights_dtype == torch.int8 else 8
    return rnn_cond == "normal" and num_rnn_layers == 2 and H % align == 0


def make_fused_b1_fn(dec: Decoder, anim_input_mean, anim_input_std, anim_output_mean,
                     anim_output_std, dt, weights_dtype=torch.bfloat16):
    """The B=1 rollout through the decoder kernel. Packs the cell once,
    with ``weights_dtype`` float32, bfloat16 or int8 weights, and returns
    ``fn(state0, gaze_pos, speech_enc, style_enc)`` with the return
    convention of `rollout` (8 trajectories). The initial hidden state
    comes from the cell-state encoder, outside the kernel. On CPU tensors
    the kernel's plain PyTorch version runs instead."""
    packed = DR.pack_decoder(dec.cell, anim_input_mean, anim_input_std, anim_output_mean,
                             anim_output_std, weights_dtype)
    if packed.wx.device.type == "cuda":
        DR.card_plan(packed)  # planned once, here: a plan that does not fit raises at load

    def fn(state0, gaze_pos, speech_enc, style_enc):
        pose0 = P.vectorize_input(*state0, gaze_pos[:, 0], anim_input_mean, anim_input_std)
        h = cell_state_encoder(dec.cell_state_encoder, pose0, style_enc[:, 0])
        return DR.rollout_fused_b1(packed, h[:, 0], *state0, gaze_pos, speech_enc, style_enc, dt)

    return fn
