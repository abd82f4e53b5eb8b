"""Attention style encoder with its VAE head (counterpart of
`zeggs_tpu/models/style_encoder.py`, the ``attn`` body).

  2x[Conv1d(k=3) + ReLU + LayerNorm] -> + sinusoidal positions
  -> one FFT block (4-head self-attention, conv feed-forward)
  -> mean over the true length -> (mu | logvar).

``lengths`` masks a padded batch exactly as the reference does: activations
are re-zeroed at padding after every conv and norm, attention logits of
padded keys are set to the dtype's minimum, and the mean divides by the
true length. A single example can equally run unpadded at its own length.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from . import layers as L


def sinusoidal_pos_enc(max_len, embed_dim, timestep=10000.0):
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, embed_dim, 2, dtype=np.float32) * (-math.log(timestep) / embed_dim))
    pe = np.zeros((max_len, embed_dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


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


class AttnBody(nn.Module):
    def __init__(self, input_size, hidden_size, output_size, device=None):
        super().__init__()
        self.conv0 = nn.Conv1d(input_size, hidden_size, 3, device=device)
        self.ln0 = nn.LayerNorm(hidden_size, device=device)
        self.conv1 = nn.Conv1d(hidden_size, output_size, 3, device=device)
        self.ln1 = nn.LayerNorm(output_size, device=device)
        self.mha = MultiheadAttention(output_size, device=device)
        self.mha_ln = nn.LayerNorm(output_size, device=device)
        self.ff_conv0 = nn.Conv1d(output_size, output_size, 3, device=device)
        self.ff_conv1 = nn.Conv1d(output_size, output_size, 3, device=device)
        self.ff_ln = nn.LayerNorm(output_size, device=device)

    def forward(self, x, lengths=None):
        """x: (B, T, input_size) normalised example features; lengths: (B,)
        true lengths or None. Returns (B, output_size)."""
        B, T, _ = x.shape
        if lengths is None:
            mask = None
            lengths_f = torch.full((B,), float(T), device=x.device)
        else:
            lengths = torch.as_tensor(lengths, device=x.device)
            mask = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
            lengths_f = lengths.to(torch.float32)

        def masked(h):
            return h if mask is None else h * mask[..., None]

        h = masked(x)
        h = masked(L.layer_norm(torch.relu(L.conv1d(h, self.conv0)), self.ln0))
        h = masked(L.layer_norm(torch.relu(L.conv1d(h, self.conv1)), self.ln1))
        E = h.shape[-1]
        h = masked(h + torch.as_tensor(sinusoidal_pos_enc(T, E), device=x.device))

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
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, heads(v))
        out = L.linear(out.transpose(1, 2).reshape(B, T, E), self.mha.out_proj)
        h = masked(L.layer_norm(out + h, self.mha_ln))

        # position-wise conv feed-forward + residual + LayerNorm
        f = masked(torch.relu(L.conv1d(h, self.ff_conv0)))
        f = L.conv1d(f, self.ff_conv1)
        h = masked(L.layer_norm(f + h, self.ff_ln))
        return torch.sum(h, dim=1) / lengths_f[:, None]


class StyleEncoder(nn.Module):
    """The ``attn`` style encoder; with ``use_vae`` its output splits into
    (mu, logvar)."""

    def __init__(self, input_size, hidden_size, style_embedding_size, use_vae=True,
                 device=None):
        super().__init__()
        self.use_vae = use_vae
        self.style_embedding_size = style_embedding_size
        output_size = 2 * style_embedding_size if use_vae else style_embedding_size
        self.body = AttnBody(input_size, hidden_size, output_size, device=device)

    def forward(self, x, lengths=None, temperature=1.0, generator=None):
        """Returns (embedding, mu, logvar); mu and logvar are None without
        the VAE head. With ``generator`` the embedding is mu + eps * std,
        std = exp(logvar / 2) / temperature and eps drawn from the
        generator; without it the embedding is mu."""
        enc = self.body(x, lengths)
        if not self.use_vae:
            return enc, None, None
        C = self.style_embedding_size
        mu, logvar = enc[:, :C], enc[:, C:]
        if generator is None:
            return mu, mu, logvar
        std = torch.exp(0.5 * logvar) / temperature
        eps = torch.randn(std.shape, generator=generator, device=std.device, dtype=std.dtype)
        return mu + eps * std, mu, logvar
