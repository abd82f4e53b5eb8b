"""A frozen copy of `zeggs_tpu_torch/models/style_encoder.py` for the benchmark's plain reference.

Style encoders with their VAE head (counterpart of
`zeggs_tpu/models/style_encoder.py`), two bodies:

``attn``: 2x[Conv1d(k=3) + ReLU + LayerNorm] -> + sinusoidal positions
  -> one FFT block (4-head self-attention, conv feed-forward)
  -> mean over the true length -> (mu | logvar).
``gru``: 2x[Conv1d(k=3) + ReLU] -> bidirectional GRU -> projection of
  [forward state at the last frame | backward output at the last frame].

``lengths`` masks a padded batch exactly as the reference does: activations
are re-zeroed at padding after every conv and norm, attention logits of
padded keys are set to the dtype's minimum, the mean divides by the true
length, and the forward GRU holds its state over padding. A single example
can equally run unpadded at its own length.

Initialisation follows the JAX package's `layers.py`: the convolutions and
the projection are ConvNorm/LinearNorm layers (Xavier-uniform weights with
the gain of the next nonlinearity, PyTorch-default biases); the rest keep
PyTorch's defaults.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from . import layers as L

_GAIN = {"linear": 1.0, "relu": math.sqrt(2.0)}


def sinusoidal_pos_enc(max_len, embed_dim, timestep=10000.0):
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, embed_dim, 2, dtype=np.float32) * (-math.log(timestep) / embed_dim))
    pe = np.zeros((max_len, embed_dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _xavier(layer, gain):
    """ConvNorm / LinearNorm: Xavier-uniform weight; the bias keeps its
    PyTorch default."""
    nn.init.xavier_uniform_(layer.weight, gain=_GAIN[gain])
    return layer


class MultiheadAttention(nn.Module):
    """Parameters in the layout of torch.nn.MultiheadAttention (packed
    in-projection); the forward pass is written out in `AttnBody`."""

    def __init__(self, dim, device=None):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, device=device))
        self.out_proj = nn.Linear(dim, dim, device=device)
        nn.init.xavier_uniform_(self.in_proj_weight)
        nn.init.zeros_(self.out_proj.bias)


def _mask(lengths, B, T, device):
    """(mask (B, T) bool or None, lengths (B,) float32)."""
    if lengths is None:
        return None, torch.full((B,), float(T), device=device)
    lengths = torch.as_tensor(lengths, device=device)
    return torch.arange(T, device=device)[None, :] < lengths[:, None], lengths.to(torch.float32)


class AttnBody(nn.Module):
    def __init__(self, input_size, hidden_size, output_size, device=None):
        super().__init__()
        self.conv0 = _xavier(nn.Conv1d(input_size, hidden_size, 3, device=device), "relu")
        self.ln0 = nn.LayerNorm(hidden_size, device=device)
        self.conv1 = _xavier(nn.Conv1d(hidden_size, output_size, 3, device=device), "relu")
        self.ln1 = nn.LayerNorm(output_size, device=device)
        self.mha = MultiheadAttention(output_size, device=device)
        self.mha_ln = nn.LayerNorm(output_size, device=device)
        self.ff_conv0 = _xavier(nn.Conv1d(output_size, output_size, 3, device=device), "relu")
        self.ff_conv1 = _xavier(nn.Conv1d(output_size, output_size, 3, device=device), "linear")
        self.ff_ln = nn.LayerNorm(output_size, device=device)
        self._pos_enc = {}  # (T, device) -> the sinusoidal table there

    def pos_enc(self, T, E, device):
        """The (T, E) sinusoidal table on ``device``, copied there once: a
        captured train step copies nothing from the host. Made outside
        inference mode, so that a table first made for inference serves a
        training step too."""
        key = (T, E, torch.device(device))
        if key not in self._pos_enc:
            with torch.inference_mode(False):
                self._pos_enc[key] = torch.as_tensor(sinusoidal_pos_enc(T, E), device=device)
        return self._pos_enc[key]

    def forward(self, x, lengths=None, generator=None):
        """x: (B, T, input_size) normalised example features; lengths: (B,)
        true lengths or None; ``generator`` draws a training step's dropout
        masks (0.2 after each conv block, 0.1 on the attention weights, the
        attention output and the feed-forward output). Returns
        (B, output_size)."""
        B, T, _ = x.shape
        mask, lengths_f = _mask(lengths, B, T, x.device)

        def masked(h):
            return h if mask is None else h * mask[..., None]

        def drop(h, rate):
            return L.dropout(h, rate, generator)

        h = masked(x)
        h = masked(drop(L.layer_norm(torch.relu(L.conv1d(h, self.conv0)), self.ln0), 0.2))
        h = masked(drop(L.layer_norm(torch.relu(L.conv1d(h, self.conv1)), self.ln1), 0.2))
        E = h.shape[-1]
        h = masked(h + self.pos_enc(T, E, x.device))

        # self-attention + residual + LayerNorm
        qkv = torch.nn.functional.linear(h, self.mha.in_proj_weight, self.mha.in_proj_bias)
        q, k, v = torch.split(qkv, E, dim=-1)
        n_heads, hd = 4, E // 4

        def heads(t):
            return t.reshape(B, T, n_heads, hd).transpose(1, 2)

        logits = torch.einsum("bhqd,bhkd->bhqk", heads(q), heads(k)) / math.sqrt(hd)
        if mask is not None:
            logits = torch.where(
                mask[:, None, None, :], logits, torch.finfo(logits.dtype).min
            )
        attn = drop(torch.softmax(logits, dim=-1), 0.1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, heads(v))
        out = drop(L.linear(out.transpose(1, 2).reshape(B, T, E), self.mha.out_proj), 0.1)
        h = masked(L.layer_norm(out + h, self.mha_ln))

        # position-wise conv feed-forward + residual + LayerNorm
        f = masked(torch.relu(L.conv1d(h, self.ff_conv0)))
        f = drop(L.conv1d(f, self.ff_conv1), 0.1)
        h = masked(L.layer_norm(f + h, self.ff_ln))
        return torch.sum(h, dim=1) / lengths_f[:, None]


class GruBody(nn.Module):
    def __init__(self, input_size, hidden_size, output_size, device=None):
        super().__init__()
        self.conv0 = _xavier(nn.Conv1d(input_size, hidden_size, 3, device=device), "relu")
        self.conv1 = _xavier(nn.Conv1d(hidden_size, hidden_size, 3, device=device), "relu")
        self.gru_fwd = nn.GRUCell(hidden_size, hidden_size, device=device)
        self.gru_bwd = nn.GRUCell(hidden_size, hidden_size, device=device)
        self.proj = _xavier(nn.Linear(2 * hidden_size, output_size, device=device), "linear")

    def forward(self, x, lengths=None, generator=None):
        """x: (B, T, input_size), lengths: (B,) or None -> (B, output_size).
        The body has no dropout; ``generator`` is accepted for the common
        signature.

        The forward GRU runs over every frame and holds its state over
        padding, so its last state is the state at each row's last frame.
        The backward GRU's output at that frame has seen that frame alone,
        from a zero state (its reverse scan starts at the end and holds
        zeros over the padding): one GRU step, the same value as the
        reference's full reverse scan read at ``lengths - 1``."""
        B, T, _ = x.shape
        mask, _ = _mask(lengths, B, T, x.device)

        def masked(h):
            return h if mask is None else h * mask[..., None]

        h = masked(torch.relu(L.conv1d(masked(x), self.conv0)))
        h = masked(torch.relu(L.conv1d(h, self.conv1)))

        gi = torch.nn.functional.linear(h, self.gru_fwd.weight_ih, self.gru_fwd.bias_ih)
        state = h.new_zeros((B, self.gru_fwd.hidden_size))
        for t in range(T):
            gh = torch.nn.functional.linear(state, self.gru_fwd.weight_hh, self.gru_fwd.bias_hh)
            new = L.gru_gates(gi[:, t], gh, state)
            state = new if mask is None else torch.where(mask[:, t, None], new, state)
        if lengths is None:
            last = h[:, -1]
        else:
            idx = torch.clamp(torch.as_tensor(lengths, device=x.device) - 1, 0, T - 1)
            last = h[torch.arange(B, device=x.device), idx]
        back = L.gru_cell(last, torch.zeros_like(state), self.gru_bwd)
        return L.linear(torch.cat([state, back], dim=-1), self.proj)


BODIES = {"attn": AttnBody, "gru": GruBody}


class StyleEncoder(nn.Module):
    """The style encoder with body ``encoder_type`` ("attn" or "gru"); with
    ``use_vae`` its output splits into (mu, logvar)."""

    def __init__(self, input_size, hidden_size, style_embedding_size, use_vae=True,
                 encoder_type="attn", device=None):
        super().__init__()
        if encoder_type not in BODIES:
            raise ValueError(f"unknown style encoder type {encoder_type!r}")
        self.use_vae = use_vae
        self.encoder_type = encoder_type
        self.style_embedding_size = style_embedding_size
        output_size = 2 * style_embedding_size if use_vae else style_embedding_size
        self.body = BODIES[encoder_type](input_size, hidden_size, output_size, device=device)

    def forward(self, x, lengths=None, temperature=1.0, generator=None, train=False):
        """Returns (embedding, mu, logvar); mu and logvar are None without
        the VAE head. With ``generator`` the embedding is mu + eps * std,
        std = exp(logvar / 2) / temperature and eps drawn from the
        generator; without it the embedding is mu. ``train`` also draws the
        body's dropout masks from the generator."""
        enc = self.body(x, lengths, generator if train else None)
        if not self.use_vae:
            return enc, None, None
        C = self.style_embedding_size
        mu, logvar = enc[:, :C], enc[:, C:]
        if generator is None:
            return mu, mu, logvar
        std = torch.exp(0.5 * logvar) / temperature
        eps = L.draw(torch.randn, std.shape, generator, std.device, std.dtype)
        return mu + eps * std, mu, logvar
