"""The FiLM decoder's operations and bytes, from the configuration's widths
alone (the yardstick of `flops.py`, for the ``film`` cell of
`reference/decoder_film.py`).

A step's products: layer0 over [pose | speech], GRU0's input product over
[hidden | pose | speech] and its hidden product, GRU1's two products,
layer2, the output layer, and the style's gammas and betas. A rollout
program computes the speech part of layer0's and GRU0's input products and
the gammas and betas once over a chunk, before its first replay; the rest
of the step, and the weights it reads, is what the chunk's replays do.
"""

from __future__ import annotations

from . import flops


def _widths(cfg):
    w = flops._widths(cfg)
    return w["P"], w["S"], w["C"], w["H"], w["O"], cfg["dataset"]["njoints"]


def hoisted_flops(cfg):
    """Forward products of one frame's conditioning: the speech part of
    layer0's and GRU0's input products, the gammas and the betas."""
    P, S, C, H, O, _ = _widths(cfg)
    return 2 * (S * H + S * 3 * H + C * 4 * H)


def step_weights(cfg):
    """(product weights, biases) a replayed step reads: layer0's pose part,
    GRU0's hidden and pose input parts, GRU0's hidden product, GRU1, layer2
    and the output layer."""
    P, S, C, H, O, _ = _widths(cfg)
    weights = H * P + 3 * H * (H + P) + 3 * H * H + 2 * 3 * H * H + H * H + O * H
    biases = 3 * H + 2 * 3 * H + H + O
    return weights, biases


def decoder_step_flops(cfg):
    """Forward products of one decoder step, the hoisted conditioning
    included."""
    return hoisted_flops(cfg) + 2 * step_weights(cfg)[0]


def rollout_flops_per_frame(cfg):
    """Forward products a generated frame needs: the speech encoder's and a
    FiLM decoder step's."""
    return flops.speech_encoder_flops(cfg, 1) + decoder_step_flops(cfg)


def step_bytes(cfg, B):
    """Bytes one replayed step of B rows moves, each read or written once:
    the step's weights and biases; each row's carry (the two hidden states
    and the eight pose tensors) read and written; its columns of the gaze,
    pre_l0, pre_g0, gammas and betas read; its four outputs (root_pos,
    root_rot, lpos, ltxy) written. float32."""
    P, S, C, H, O, J = _widths(cfg)
    weights, biases = step_weights(cfg)
    carry = 2 * H + (3 + 4 + 3 + 3) + J * (3 + 6 + 3 + 3)
    columns = 3 + H + 3 * H + 2 * H + 2 * H
    outputs = 3 + 4 + J * (3 + 6)
    return 4 * (weights + biases + B * (2 * carry + columns + outputs))


def step_bound_s(cfg, B):
    """The least seconds an H100 needs for one replayed step of B rows: the
    larger of `step_bytes` over the memory bandwidth and the in-step
    products (2 B per weight) over the float32 peak."""
    return flops.bound_s(step_bytes(cfg, B), 2 * B * step_weights(cfg)[0])
