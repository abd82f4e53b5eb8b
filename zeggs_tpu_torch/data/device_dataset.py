"""Device-resident corpus with on-device batch gathering (counterpart of
`zeggs_tpu/data/device_dataset.py::DeviceCorpus`).

The processed corpus (float32 feature tracks, ~1-2 GB for the full
dataset) is uploaded once; each training step then ships only (B,) window
starts and a (B, 2 * example_length) matrix of example rows, and
`gather_batch` indexes the corpus on the device. The example re-centring,
clamping and tail-repeat logic stays on the host (`sample_indices`, the
index arithmetic of `WindowedDataset.get_example`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import require_device
from .dataset import WindowedDataset

WINDOW_KEYS = (
    "audio_features", "root_pos", "root_rot", "root_vel", "root_vrt",
    "lpos", "ltxy", "lvel", "lvrt", "gaze_pos",
)
_EXAMPLE_KEYS = ("root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt")


class DeviceCorpus:
    def __init__(self, ds: WindowedDataset, device="cuda"):
        """Upload ``ds``'s feature tracks to ``device`` (the card unless the
        caller asks for the CPU; raises without it)."""
        self.ds = ds
        self.device = require_device(device)
        self.window = ds.window
        self.max_example_length = ds.max_example_length
        self.arrays = {
            k: torch.as_tensor(np.asarray(ds.arrays[k], np.float32), device=self.device)
            for k in WINDOW_KEYS
        }
        self._steps = torch.arange(self.window, device=self.device)

    # -- host-side index construction ------------------------------------

    def sample_indices(self, batch_indices, example_window_length):
        """Window indices -> (window starts (B,), example rows (B, Lmax),
        example lengths (B,)), int32 numpy arrays."""
        ds = self.ds
        starts = ds.window_starts[batch_indices].astype(np.int32)
        B = len(batch_indices)
        ex_idx = np.zeros((B, self.max_example_length), np.int32)
        ex_len = np.zeros(B, np.int32)
        for i, (idx, w_start) in enumerate(zip(batch_indices, starts)):
            rows = self._example_rows(int(w_start), ds.ranges_train[ds.window_samples[idx]],
                                      example_window_length)
            ex_idx[i, : len(rows)] = rows
            ex_len[i] = len(rows)
        return starts, ex_idx, ex_len

    def _example_rows(self, w_start, sample_range, ewl):
        ds = self.ds
        w_end = w_start + self.window
        ext = (ewl - self.window) // 2
        ws = min(ext, w_start - sample_range[0])
        we = min(ext, sample_range[1] - (w_end - 1))
        s_ext = ws + ext - we
        w_ext = we + ext - ws
        start = max(w_start - s_ext, sample_range[0])
        end = min((w_end - 1) + w_ext, sample_range[1]) + 1
        end = min(end, ds.arrays["root_vel"].shape[0])
        rows = np.arange(start, end, dtype=np.int32)
        cur = len(rows)
        if cur < ewl:
            rows = np.concatenate([rows, rows[-(ewl - cur):]])
        return rows

    # -- device-side gathering --------------------------------------------

    def gather_batch(self, window_starts, ex_idx=None, ex_lengths=None, labels=None,
                     nlabels=None):
        """The training batch on the device from small index arrays (numpy
        or tensors); equals `WindowedDataset.make_batch`. ``labels`` gives
        one-hot label styles, else ``ex_idx``/``ex_lengths`` the examples."""

        def dev(a):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                   device=self.device).long()

        gather = dev(window_starts)[:, None] + self._steps[None, :]
        batch = {k: self.arrays[k][gather] for k in WINDOW_KEYS}
        if labels is not None:
            batch["style"] = torch.nn.functional.one_hot(dev(labels), nlabels).float()
            return batch
        ex_idx, ex_lengths = dev(ex_idx), dev(ex_lengths)
        B, Lmax = ex_idx.shape
        parts = [self.arrays[k][ex_idx].reshape(B, Lmax, -1) for k in _EXAMPLE_KEYS]
        parts.append(torch.zeros((B, Lmax, 3), device=self.device))
        ex = torch.cat(parts, dim=-1)
        mask = torch.arange(Lmax, device=self.device)[None, :] < ex_lengths[:, None]
        batch["example"] = ex * mask[..., None]
        batch["example_lengths"] = ex_lengths.to(torch.int32)
        return batch
