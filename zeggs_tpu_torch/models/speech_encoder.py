"""Speech encoder (counterpart of `zeggs_tpu/models/speech_encoder.py`):
Conv1d(k=1) -> ELU -> Conv1d(k=31, replicate padding) -> ELU -> Linear -> ELU.
Dropout is a no-op at inference and is left out."""

from __future__ import annotations

import torch.nn as nn

from . import layers as L


class SpeechEncoder(nn.Module):
    def __init__(self, input_size, hidden_size, output_size, device=None):
        super().__init__()
        self.conv0 = nn.Conv1d(input_size, hidden_size, 1, device=device)
        self.conv1 = nn.Conv1d(hidden_size, output_size, 31, device=device)
        self.linear = nn.Linear(output_size, output_size, device=device)

    def forward(self, x):
        """x: (B, T, n_audio_features), already mean/std normalised."""
        h = L.elu(L.conv1d(x, self.conv0, padding="replicate"))
        h = L.elu(L.conv1d(h, self.conv1, padding="replicate"))
        return L.elu(L.linear(h, self.linear))
