"""A frozen copy of `zeggs_tpu_torch/models/speech_encoder.py` for the benchmark's plain reference.

Speech encoder (counterpart of `zeggs_tpu/models/speech_encoder.py`):
Conv1d(k=1) -> ELU -> Dropout(0.2) -> Conv1d(k=31, replicate padding) -> ELU
-> Dropout(0.2) -> Linear -> ELU. Dropout runs only when a training step
passes its generator."""

from __future__ import annotations

import torch.nn as nn

from . import layers as L


class SpeechEncoder(nn.Module):
    def __init__(self, input_size, hidden_size, output_size, device=None):
        super().__init__()
        self.conv0 = nn.Conv1d(input_size, hidden_size, 1, device=device)
        self.conv1 = nn.Conv1d(hidden_size, output_size, 31, device=device)
        self.linear = nn.Linear(output_size, output_size, device=device)

    def forward(self, x, generator=None):
        """x: (B, T, n_audio_features), already mean/std normalised;
        ``generator`` draws the dropout masks of a training step."""
        h = L.dropout(L.elu(L.conv1d(x, self.conv0, padding="replicate")), 0.2, generator)
        h = L.dropout(L.elu(L.conv1d(h, self.conv1, padding="replicate")), 0.2, generator)
        return L.elu(L.linear(h, self.linear))
