"""A frozen copy of `zeggs_tpu_torch/models/layers.py` for the benchmark's plain reference.

Primitive layers on (B, T, C) tensors (counterpart of
`zeggs_tpu/models/layers.py`). Weights are in PyTorch layout: linear
(out, in), conv (out, in, K), GRU (3H, in) with gates r, z, n."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def linear(x, layer: nn.Linear):
    return F.linear(x, layer.weight, layer.bias)


def conv1d(x, layer: nn.Conv1d, padding="zero"):
    """'Same'-length 1-D convolution over (B, T, C): (k-1)//2 frames of
    padding on the left and k//2 on the right, zeros or ('replicate') the
    edge frame, then a valid convolution."""
    k = layer.weight.shape[-1]
    h = x.transpose(1, 2)
    pad = ((k - 1) // 2, k // 2)
    if padding == "replicate":
        h = F.pad(h, pad, mode="replicate")
    else:
        h = F.pad(h, pad)
    return F.conv1d(h, layer.weight, layer.bias).transpose(1, 2)


def layer_norm(x, layer: nn.LayerNorm):
    return F.layer_norm(x, layer.normalized_shape, layer.weight, layer.bias, layer.eps)


def elu(x):
    return F.elu(x)


class RowShard(NamedTuple):
    """A generator for one process's rows of a global batch: every draw is
    made at the global batch's shape (``rows`` on the leading axis), and the
    process keeps rows [start, start + its batch). So each process draws the
    noise a single process would draw for those rows, and the generator
    moves on as it would in a single process."""

    generator: torch.Generator
    rows: int
    start: int


def draw(fn, shape, generator, device, dtype):
    """``fn`` (`torch.rand` or `torch.randn`) of ``shape`` from ``generator``,
    a `torch.Generator` or a `RowShard` (``shape[0]`` this process's rows)."""
    if isinstance(generator, RowShard):
        full = fn((generator.rows, *shape[1:]), generator=generator.generator, device=device,
                  dtype=dtype)
        return full[generator.start : generator.start + shape[0]]
    return fn(tuple(shape), generator=generator, device=device, dtype=dtype)


def dropout(x, rate, generator=None):
    """Inverted dropout with torch's scaling: each element is kept with
    probability 1 - rate, drawn from ``generator`` on x's device (see
    `draw`), and scaled by 1 / (1 - rate). No generator, no dropout
    (inference, or a deterministic training step)."""
    if generator is None or rate == 0.0:
        return x
    keep = draw(torch.rand, x.shape, generator, x.device, x.dtype) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def gru_cell(x, h, cell: nn.GRUCell):
    """One GRU step with PyTorch's equations:
    r = s(W_ir x + b_ir + W_hr h + b_hr); z = s(...);
    n = tanh(i_n + r * h_n); h' = (1 - z) * n + z * h."""
    gi = F.linear(x, cell.weight_ih, cell.bias_ih)
    gh = F.linear(h, cell.weight_hh, cell.bias_hh)
    return gru_gates(gi, gh, h)


def gru_gates(gi, gh, h):
    """The GRU nonlinearity from the two (.., 3H) gate products."""
    H = h.shape[-1]
    r = torch.sigmoid(gi[..., :H] + gh[..., :H])
    z = torch.sigmoid(gi[..., H : 2 * H] + gh[..., H : 2 * H])
    n = torch.tanh(gi[..., 2 * H :] + r * gh[..., 2 * H :])
    return (1.0 - z) * n + z * h
