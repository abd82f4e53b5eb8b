"""Autoregressive gesture decoder (counterpart of
`zeggs_tpu/models/decoder.py`), with its two recurrent cells.

A cell-state encoder sets the two GRU layers' hidden state from (frame-0
pose, style); then each frame runs vectorize_input -> the cell ->
devectorize_output and feeds the integrated pose back.

``normal``: Linear+ELU skip into GRU0 -> GRU1 -> Linear. `rollout_chunk`
  is an eager loop over frames with the speech/style part of every
  per-frame product hoisted out of the loop as one product over all
  frames, the plain counterpart of the reference's scan. At inference GRU1
  of every step is one launch of the GRU-cell CUDA kernel
  (`ops/kernels/gru_cell.py`) on a card, its plain version on the CPU;
  ``quantize_int8`` runs the step's products on int8 values instead. Where
  autograd records (a training step) at float32 compute, without remat
  and with every trajectory asked for, the whole window is one autograd
  Function with its backward through time written by hand
  (`ops/kernels/decoder_train.py`: CUDA step kernels on a card, their
  plain versions on the CPU). Under other options (bfloat16 compute,
  remat) every step is the plain differentiable math over the live
  parameters, with the products in ``compute_dtype``. `chunk_step` gives
  that step and the hoisted products; `infer/programs.py` replays the
  inference step from CUDA graphs. On float32 CUDA tensors the inference
  step's element-wise math (the pose in and out, the ELU, GRU0's gates) is
  four launches of `ops/kernels/decoder_step.py`'s kernels between the
  products, bit for bit the plain expressions the CPU runs.
``film``: style enters only through per-layer (gamma, beta) modulation and
  the GRU input is [hidden | pose | speech]. At inference `rollout_chunk`
  runs it as it runs ``normal``: the speech part of layer0's and GRU0's
  input products and the style's gammas and betas hoisted over all frames,
  GRU1 through the GRU-cell kernel, the element-wise math through the same
  kernels as ``normal`` (the scale and shift an operand of the ELU kernel,
  which also runs layer2's), and `infer/programs.py` replays the step from
  CUDA graphs. Where autograd records, `rollout` takes
  `rollout_film`, the reference's plain step over the live parameters.
  Neither int8 products nor the B=1 kernel run it.

At B=1 on a card `make_fused_b1_fn` runs a ``normal`` rollout as one
launch of the CUDA kernel in `ops/kernels/decoder_rollout.py`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels import decoder_rollout as DR
from ..ops.kernels import decoder_step as DS
from ..ops.kernels import decoder_train as DT
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


class FilmCell(nn.Module):
    """Style-modulated cell: gammas and betas (Xavier-uniform weights, as the
    reference's LinearNorm) scale and shift the two hidden layers. The GRU0
    input is [hidden | pose | speech]; layer0's is [pose | speech]."""

    def __init__(self, pose_input_size, speech_encoding_size, style_encoding_size, hidden_size,
                 pose_output_size, device=None):
        super().__init__()
        ps_input = pose_input_size + speech_encoding_size
        self.gammas = nn.Linear(style_encoding_size, 2 * hidden_size, device=device)
        self.betas = nn.Linear(style_encoding_size, 2 * hidden_size, device=device)
        nn.init.xavier_uniform_(self.gammas.weight)
        nn.init.xavier_uniform_(self.betas.weight)
        self.layer0 = nn.Linear(ps_input, hidden_size, device=device)
        self.gru0 = nn.GRUCell(ps_input + hidden_size, hidden_size, device=device)
        self.gru1 = nn.GRUCell(hidden_size, hidden_size, device=device)
        self.layer2 = nn.Linear(hidden_size, hidden_size, device=device)
        self.out = nn.Linear(hidden_size, pose_output_size, device=device)


class Decoder(nn.Module):
    def __init__(self, pose_input_size, pose_output_size, speech_encoding_size,
                 style_encoding_size, hidden_size, num_rnn_layers=2, rnn_cond="normal",
                 device=None):
        super().__init__()
        if num_rnn_layers != 2:
            raise NotImplementedError(
                f"the decoder cells run 2 GRU layers, not {num_rnn_layers}"
            )
        self.num_rnn_layers = num_rnn_layers
        self.rnn_cond = rnn_cond
        self.cell_state_encoder = CellStateEncoder(
            pose_input_size + style_encoding_size, hidden_size, num_rnn_layers, device=device
        )
        if rnn_cond == "normal":
            all_input = pose_input_size + speech_encoding_size + style_encoding_size
            self.cell = NormalCell(all_input, hidden_size, pose_output_size, device=device)
        elif rnn_cond == "film":
            self.cell = FilmCell(pose_input_size, speech_encoding_size, style_encoding_size,
                                 hidden_size, pose_output_size, device=device)
        else:
            raise ValueError(f"unknown rnn_cond {rnn_cond!r}")


def _records_grad(module: nn.Module):
    """Whether autograd records a call on ``module``'s parameters now."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in module.parameters())


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


def chunk_step(dec: Decoder, anim_input_mean, anim_input_std, anim_output_mean, anim_output_std,
               dt, njoints, quantize_int8=False, compute_dtype=torch.float32):
    """The frame step of ``dec``'s cell as `rollout_chunk` runs it ->
    (conditioning, step, plain).

    ``conditioning(speech (B, n, S), style (B, n, C))`` gives the cell's
    hoisted per-frame tensors for all n frames: for ``normal`` the
    speech/style part of layer0's and of GRU0's input product, (pre_l0
    (B, n, H), pre_g0 (B, n, 3H)); for ``film`` the speech part of the two
    products and the style's modulation, (pre_l0, pre_g0, gammas (B, n,
    2H), betas (B, n, 2H)). ``step(gaze_t, *cond_t, h0, h1, root_pos,
    root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt)`` advances one
    frame from one column of the gaze and of each conditioning tensor and
    returns the new state in the same order. ``plain`` says whether the
    step is the differentiable plain math (autograd records, or
    ``compute_dtype`` is not float32); otherwise GRU1 runs through the
    GRU-cell kernel and, on a float32 CUDA state, the step's element-wise
    math through the kernels of `ops/kernels/decoder_step.py`
    (`decoder_step.step_ops`; int8: its pose kernels). The weights are
    derived once, here, so a caller that keeps the step (a CUDA graph of
    it) keeps them."""
    cp = dec.cell
    film = dec.rnn_cond == "film"
    pose_dim = anim_input_mean.shape[-1]
    H = cp.gru1.weight_hh.shape[1]
    plain = _records_grad(dec) or compute_dtype != torch.float32
    if quantize_int8 and film:
        raise ValueError("int8 rollouts run the 'normal' cell only")
    if quantize_int8 and plain:
        raise ValueError("int8 rollouts are inference only, at float32 compute")
    cd = compute_dtype

    w0 = cp.layer0.weight.to(cd)
    wg = cp.gru0.weight_ih.to(cd)
    w0_pose, wg_h, wg_pose = w0[:, :pose_dim], wg[:, :H], wg[:, H : H + pose_dim]

    def conditioning(speech_encoding, style_encoding):
        # layer0's input is [pose | speech | style] (film: [pose | speech])
        cond = speech_encoding if film else torch.cat([speech_encoding, style_encoding], dim=-1)
        cond = cond.to(cd)
        hoisted = (F.linear(cond, w0[:, pose_dim:], cp.layer0.bias.to(cd)),
                   F.linear(cond, wg[:, H + pose_dim :], cp.gru0.bias_ih.to(cd)))
        if film:
            style = style_encoding.to(cd)
            hoisted += (F.linear(style, cp.gammas.weight.to(cd), cp.gammas.bias.to(cd)) + 1.0,
                        F.linear(style, cp.betas.weight.to(cd), cp.betas.bias.to(cd)))
        return hoisted

    if quantize_int8:
        q_w0_pose, q_wg_h, q_wg_pose = (_quantize_weight(w) for w in (w0_pose, wg_h, wg_pose))
        q_g0_whh, q_g1_wih, q_g1_whh, q_w_out = (
            _quantize_weight(w)
            for w in (cp.gru0.weight_hh, cp.gru1.weight_ih, cp.gru1.weight_hh, cp.out.weight)
        )

        def cell(ops, pose, cond_t, h0, h1):
            l0_t, g0_t = cond_t
            pose_q = _quantize_act(pose)
            hidden = L.elu(l0_t + _qdot(pose_q, q_w0_pose))
            gi = g0_t + _qdot(_quantize_act(hidden), q_wg_h) + _qdot(pose_q, q_wg_pose)
            gh = _qdot(_quantize_act(h0), q_g0_whh) + cp.gru0.bias_hh
            h0_new = L.gru_gates(gi, gh, h0)
            gi1 = _qdot(_quantize_act(h0_new), q_g1_wih) + cp.gru1.bias_ih
            gh1 = _qdot(_quantize_act(h1), q_g1_whh) + cp.gru1.bias_hh
            h1_new = L.gru_gates(gi1, gh1, h1)
            return h0_new, h1_new, _qdot(_quantize_act(h1_new), q_w_out) + cp.out.bias
    else:
        whh0, bhh0 = cp.gru0.weight_hh.to(cd), cp.gru0.bias_hh.to(cd)
        w_out, b_out = cp.out.weight.to(cd), cp.out.bias.to(cd)
        if film:
            w2, b2 = cp.layer2.weight.to(cd), cp.layer2.bias.to(cd)
        if plain:
            g1 = [t.to(cd) for t in (cp.gru1.weight_ih, cp.gru1.bias_ih, cp.gru1.weight_hh,
                                     cp.gru1.bias_hh)]

            def gru1_step(x, h):
                return L.gru_gates(F.linear(x, g1[0], g1[1]), F.linear(h, g1[2], g1[3]), h)
        else:
            packed = GC.pack_gru(cp.gru1)  # biases folded once, not per step

            def gru1_step(x, h):
                return GC.fused_gru_cell(packed, x, h)

        def cell(ops, pose, cond_t, h0, h1):
            l0_t, g0_t = cond_t[:2]
            pose_c, h0, h1 = pose.to(cd), h0.to(cd), h1.to(cd)
            scale_shift = ((), ())
            if film:
                gammas, betas = cond_t[2:]
                scale_shift = ((gammas[:, :H], betas[:, :H]), (gammas[:, H:], betas[:, H:]))
            hidden = ops.elu(l0_t, pose_c @ w0_pose.T, *scale_shift[0])
            h0_new = ops.gru_gates(g0_t, hidden @ wg_h.T, pose_c @ wg_pose.T,
                                   F.linear(h0, whh0, bhh0), h0)
            h1_new = gru1_step(h0_new, h1)
            top = h1_new
            if film:
                top = ops.elu(F.linear(h1_new, w2, b2), None, *scale_shift[1])
            sd = pose.dtype  # the state's dtype
            return h0_new.to(sd), h1_new.to(sd), F.linear(top, w_out, b_out).to(sd)

    n_cond = 4 if film else 2

    def step(gaze_t, *args):
        cond_t, (h0, h1, rp, rr, rv, rw, jp, jt, jv, jw) = args[:n_cond], args[n_cond:]
        ops = DS.step_ops(rp, plain)
        pose = ops.pose_in(rp, rr, rv, rw, jp, jt, jv, jw, gaze_t, anim_input_mean,
                           anim_input_std)
        h0, h1, out = cell(ops, pose, cond_t, h0, h1)
        return (h0, h1) + ops.pose_out(out, rp, rr, njoints, dt, anim_output_mean,
                                       anim_output_std)

    return conditioning, step, plain


def rollout_chunk(dec: Decoder, carry, gaze_pos, speech_encoding, style_encoding,
                  anim_input_mean, anim_input_std, anim_output_mean, anim_output_std, dt,
                  output_indices=None, quantize_int8=False, compute_dtype=torch.float32,
                  remat=False):
    """Advance ``speech_encoding.shape[1]`` frames of ``dec``'s cell from
    ``carry``; each column of the (B, n, ...) conditioning is one step.
    Returns (new_carry, trajectories (B, n, ...)).

    Where autograd records on the ``normal`` decoder's parameters at
    float32 compute, without ``remat`` or ``output_indices``, the window
    runs as `ops.kernels.decoder_train.DecoderBPTT` (the same math,
    backward through time written by hand). Otherwise, where autograd
    records or ``compute_dtype`` is not float32, every step is the
    differentiable plain math of the reference's scan: products in
    ``compute_dtype`` over the live parameters, states and pose integration
    in float32. ``remat`` recomputes each step in the backward pass instead
    of storing it. Otherwise (inference) GRU1 runs through the GRU-cell
    kernel, one eager launch a step; `infer/programs.py` replays the same
    step from CUDA graphs.

    quantize_int8 (inference, ``normal`` cell): the in-step products run
    on symmetric int8 weights with one scale per output row and activations
    quantized dynamically with one scale per batch row (floors 1e-12), as
    the JAX package's batched int8 path does; the speech/style projections
    stay float32."""
    conditioning, step, plain = chunk_step(
        dec, anim_input_mean, anim_input_std, anim_output_mean, anim_output_std, dt,
        carry[5].shape[1], quantize_int8, compute_dtype)
    cond = conditioning(speech_encoding, style_encoding)
    # autograd records on the decoder (``plain`` at float32 compute), no
    # remat, every trajectory asked for
    if (dec.rnn_cond == "normal" and plain and compute_dtype == torch.float32 and not remat
            and output_indices is None and speech_encoding.shape[1] > 0):
        return DT.rollout_bptt(dec.cell, carry, gaze_pos, *cond, anim_input_mean,
                               anim_input_std, anim_output_mean, anim_output_std, dt)
    h, *pose_state = carry
    # the cell-state encoder's h is a transposed view
    state = (h[0], h[1].contiguous(), *pose_state)
    emitted = []
    for t in range(speech_encoding.shape[1]):
        args = (gaze_pos[:, t], *(c[:, t] for c in cond)) + state
        state = checkpoint(step, *args, use_reentrant=False) if remat and plain else step(*args)
        new = state[2:]
        emitted.append(new if output_indices is None else tuple(new[i] for i in output_indices))
    new_carry = (torch.stack(state[:2]),) + tuple(state[2:])
    return new_carry, _stack_emitted(emitted, carry, output_indices)


def _stack_emitted(emitted, carry, output_indices):
    """Per-step output tuples -> (B, n, ...) trajectories; an empty chunk
    gives (B, 0, ...) tensors."""
    if not emitted:
        ref = carry[1:] if output_indices is None else tuple(carry[1 + i] for i in output_indices)
        return tuple(x[:, None][:, :0] for x in ref)
    return tuple(torch.stack([e[i] for e in emitted], dim=1) for i in range(len(emitted[0])))


def rollout_film(dec: Decoder, carry, gaze_pos, speech_encoding, style_encoding,
                 anim_input_mean, anim_input_std, anim_output_mean, anim_output_std, dt,
                 output_indices=None):
    """Advance ``speech_encoding.shape[1]`` frames of the ``film`` cell from
    ``carry`` (`_rollout_film` of the reference, float32, every step plain,
    nothing hoisted): the training rollout of the ``film`` cell.
    Returns (new_carry, trajectories (B, n, ...))."""
    cp = dec.cell
    njoints = carry[5].shape[1]
    H = cp.gru1.weight_hh.shape[1]
    gammas = F.linear(style_encoding, cp.gammas.weight, cp.gammas.bias) + 1.0
    betas = F.linear(style_encoding, cp.betas.weight, cp.betas.bias)
    h, *pose_state = carry
    h0, h1 = h[0], h[1]
    emitted = []
    for t in range(speech_encoding.shape[1]):
        rp, rr = pose_state[0], pose_state[1]
        pose = P.vectorize_input(*pose_state, gaze_pos[:, t], anim_input_mean, anim_input_std)
        ps = torch.cat([pose, speech_encoding[:, t]], dim=-1)
        hidden = L.elu(L.linear(ps, cp.layer0)) * gammas[:, t, :H] + betas[:, t, :H]
        h0 = L.gru_cell(torch.cat([hidden, ps], dim=-1), h0, cp.gru0)
        h1 = L.gru_cell(h0, h1, cp.gru1)
        hid2 = L.elu(L.linear(h1, cp.layer2)) * gammas[:, t, H:] + betas[:, t, H:]
        new = P.devectorize_output(L.linear(hid2, cp.out), rp, rr, njoints, dt,
                                   anim_output_mean, anim_output_std)
        pose_state = list(new)
        emitted.append(new if output_indices is None else tuple(new[i] for i in output_indices))
    new_carry = (torch.stack([h0, h1]),) + tuple(pose_state)
    return new_carry, _stack_emitted(emitted, carry, output_indices)


def rollout(dec: Decoder, root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
            gaze_pos, speech_encoding, style_encoding, anim_input_mean, anim_input_std,
            anim_output_mean, anim_output_std, dt, output_indices=None, quantize_int8=False,
            compute_dtype=torch.float32, remat=False):
    """Autoregressive rollout from the frame-0 state (B, ...) under per-frame
    conditioning gaze_pos (B, T, 3), speech (B, T, S), style (B, T, C).
    Returns the 8 trajectories (B, T, ...), or those in ``output_indices``,
    with frame 0 equal to the inputs. ``quantize_int8``, ``compute_dtype``
    and ``remat``: see `rollout_chunk`. Where autograd records, the
    ``film`` cell runs `rollout_film` and takes none of them, as in the
    reference."""
    carry0 = init_carry(dec, root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
                        gaze_pos[:, 0], style_encoding[:, 0], anim_input_mean, anim_input_std)
    args = (dec, carry0, gaze_pos[:, 1:], speech_encoding[:, 1:], style_encoding[:, 1:],
            anim_input_mean, anim_input_std, anim_output_mean, anim_output_std, dt)
    if dec.rnn_cond == "film" and quantize_int8:
        raise ValueError("int8 rollouts run the 'normal' cell only")
    if dec.rnn_cond == "film" and _records_grad(dec):
        _, ys = rollout_film(*args, output_indices=output_indices)
    else:
        _, ys = rollout_chunk(*args, output_indices=output_indices, quantize_int8=quantize_int8,
                              compute_dtype=compute_dtype, remat=remat)
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
    return (rnn_cond == "normal" and dec.rnn_cond == "normal" and num_rnn_layers == 2
            and H % align == 0)


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
