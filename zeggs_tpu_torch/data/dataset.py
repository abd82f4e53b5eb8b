"""Windowed training dataset over the processed corpus (the port's copy of
`zeggs_tpu/data/dataset.py`, pure numpy).

Fixed ``window``-frame training slices enumerated densely over every
training range, one-hot labels or style-example windows re-centred around
the training window with boundary clamping and tail-repeat padding.
Batches come from numpy fancy indexing over the memory-mapped processed
arrays. Examples are padded to ``2 * example_length`` with a lengths
vector; the style encoder masks. For the same `np.random.Generator` state
every draw is the JAX package's, in the same order, so the batches are
bit-identical.
"""

from __future__ import annotations

import json

import numpy as np

_FEATURE_KEYS = (
    "audio_features",
    "root_pos",
    "root_rot",
    "root_vel",
    "root_vrt",
    "lpos",
    "ltxy",
    "lvel",
    "lvrt",
    "gaze_pos",
)

_NPZ_KEYS = {
    "audio_features": "X_audio_features",
    "root_pos": "Y_root_pos",
    "root_rot": "Y_root_rot",
    "root_vel": "Y_root_vel",
    "root_vrt": "Y_root_vrt",
    "lpos": "Y_lpos",
    "ltxy": "Y_ltxy",
    "lvel": "Y_lvel",
    "lvrt": "Y_lvrt",
    "gaze_pos": "Y_gaze_pos",
}


class WindowedDataset:
    def __init__(
        self,
        path_data_definition,
        path_processed_data,
        window,
        style_encoding_type="example",
        example_length=256,
    ):
        with open(path_data_definition) as f:
            details = json.load(f)
        self.details = details
        self.njoints = len(details["bone_names"])
        self.nlabels = len(details["label_names"])
        self.label_names = details["label_names"]
        self.bone_names = details["bone_names"]
        self.parents = np.asarray(details["parents"], np.int32)
        self.dt = float(details["dt"])
        self.window = int(window)
        self.style_encoding_type = style_encoding_type
        self.example_length = int(example_length)
        self.max_example_length = 2 * self.example_length

        data = np.load(path_processed_data, mmap_mode="r")
        self.arrays = {k: data[v] for k, v in _NPZ_KEYS.items()}
        self.ranges_train = np.asarray(data["ranges_train"])
        self.ranges_valid = np.asarray(data["ranges_valid"])
        self.ranges_train_labels = np.asarray(data["ranges_train_labels"])
        self.ranges_valid_labels = np.asarray(data["ranges_valid_labels"])

        self.stats = {
            k: np.asarray(data[k], np.float32)
            for k in (
                "audio_input_mean",
                "audio_input_std",
                "anim_input_mean",
                "anim_input_std",
                "anim_output_mean",
                "anim_output_std",
            )
        }

        # dense window index: (start, sample_idx, label) per window
        starts, samples, labels = [], [], []
        for si, ((s, e), lab) in enumerate(zip(self.ranges_train, self.ranges_train_labels)):
            n = e - self.window - s
            if n <= 0:
                continue
            starts.append(np.arange(s, e - self.window))
            samples.append(np.full(n, si, np.int32))
            labels.append(np.full(n, lab, np.int32))
        self.window_starts = np.concatenate(starts) if starts else np.zeros(0, np.int64)
        self.window_samples = np.concatenate(samples) if samples else np.zeros(0, np.int32)
        self.window_labels = np.concatenate(labels) if labels else np.zeros(0, np.int32)

    def __len__(self):
        return len(self.window_starts)

    def get_shapes(self):
        return dict(
            num_audio_features=self.arrays["audio_features"].shape[1],
            pose_input_size=len(self.stats["anim_input_std"].ravel())
            if self.stats["anim_input_std"].ndim
            else 1,
            pose_output_size=len(self.stats["anim_output_std"].ravel()),
        )

    # -- example windows ---------------------------------------------------

    def example_feature_vec(self, start, end):
        """(end-start, 1134) example features with zero gaze slot
        (dataset.py:188-196)."""
        n = end - start
        a = self.arrays
        return np.concatenate(
            [
                np.asarray(a["root_vel"][start:end]).reshape(n, -1),
                np.asarray(a["root_vrt"][start:end]).reshape(n, -1),
                np.asarray(a["lpos"][start:end]).reshape(n, -1),
                np.asarray(a["ltxy"][start:end]).reshape(n, -1),
                np.asarray(a["lvel"][start:end]).reshape(n, -1),
                np.asarray(a["lvrt"][start:end]).reshape(n, -1),
                np.zeros((n, 3), np.float32),
            ],
            axis=1,
        ).astype(np.float32)

    def get_example(self, w_start, w_end, sample_range, example_window_length):
        """Re-center an example window of ``example_window_length`` frames
        around [w_start, w_end), clamped to the clip and tail-repeat padded
        (dataset.py:176-204)."""
        ext = (example_window_length - self.window) // 2
        ws = min(ext, w_start - sample_range[0])
        we = min(ext, sample_range[1] - (w_end - 1))
        s_ext = ws + ext - we
        w_ext = we + ext - ws
        start = max(w_start - s_ext, sample_range[0])
        end = min((w_end - 1) + w_ext, sample_range[1]) + 1
        end = min(end, self.arrays["root_vel"].shape[0])
        vec = self.example_feature_vec(int(start), int(end))
        cur = len(vec)
        if cur < example_window_length:
            vec = np.concatenate([vec, vec[-(example_window_length - cur) :]], axis=0)
        return vec

    # -- batches -------------------------------------------------------------

    def sample_example_length(self, rng):
        """2 * U{example_length//2, ..., example_length} (train.py:227-229)."""
        return int(2 * rng.integers(self.example_length // 2, self.example_length + 1))

    def make_batch(self, indices, example_window_length=None, rng=None):
        """Assemble a batch dict for the given window indices."""
        starts = self.window_starts[indices]
        gather = starts[:, None] + np.arange(self.window)[None, :]
        batch = {}
        for k in _FEATURE_KEYS:
            batch[k] = np.asarray(self.arrays[k][gather], np.float32)

        if self.style_encoding_type == "label":
            lab = self.window_labels[indices]
            one_hot = np.zeros((len(indices), self.nlabels), np.float32)
            one_hot[np.arange(len(indices)), lab] = 1.0
            batch["style"] = one_hot
        else:
            if example_window_length is None:
                example_window_length = (
                    self.sample_example_length(rng) if rng is not None else self.max_example_length
                )
            B = len(indices)
            ex = np.zeros((B, self.max_example_length, self.stats["anim_input_mean"].size), np.float32)
            lengths = np.full(B, example_window_length, np.int32)
            for i, idx in enumerate(indices):
                rng_i = self.ranges_train[self.window_samples[idx]]
                vec = self.get_example(
                    int(starts[i]), int(starts[i]) + self.window, rng_i, example_window_length
                )
                ex[i, : len(vec)] = vec[: self.max_example_length]
                lengths[i] = len(vec)
            batch["example"] = ex
            batch["example_lengths"] = lengths
        return batch

    def batches(self, batch_size, rng, drop_last=True):
        """Shuffled epoch iterator of batch dicts (numpy Generator rng)."""
        order = rng.permutation(len(self))
        n_full = len(order) // batch_size
        for b in range(n_full):
            idx = order[b * batch_size : (b + 1) * batch_size]
            yield self.make_batch(idx, rng=rng)
        if not drop_last and len(order) % batch_size:
            yield self.make_batch(order[n_full * batch_size :], rng=rng)

    # -- eval samples ---------------------------------------------------------

    def get_sample(self, which="train", length_s=None, range_index=None, rng=None):
        """Pull one whole (or length-limited) clip for eval synthesis
        (dataset.py:206-233). Returns (batch-of-1 dict, label, (s, e), idx)."""
        ranges = self.ranges_train if which == "train" else self.ranges_valid
        labels = self.ranges_train_labels if which == "train" else self.ranges_valid_labels
        if range_index is None:
            range_index = int((rng or np.random.default_rng()).integers(len(ranges)))
        s, e = ranges[range_index]
        label = int(labels[range_index])
        if length_s is not None:
            e = min(s + int(length_s) * 60, e)
        out = {
            k: np.asarray(self.arrays[k][s:e], np.float32)[None] for k in _FEATURE_KEYS
        }
        return out, label, (int(s), int(e)), range_index


def dataset_stats_table(ds: WindowedDataset):
    """Per-style frame and second counts as an ASCII table (the reference's
    dataset summary; counts are halved because the corpus stores mirrored
    versions)."""
    from ..utils.logs import ascii_table

    rows = []
    total = 0.0
    for i, label in enumerate(ds.label_names):
        tr = ds.ranges_train[ds.ranges_train_labels == i]
        va = ds.ranges_valid[ds.ranges_valid_labels == i]
        n_tr = float(np.sum(tr[:, 1] - tr[:, 0])) / 2 if len(tr) else 0.0
        n_va = float(np.sum(va[:, 1] - va[:, 0])) / 2 if len(va) else 0.0
        rows.append([label, f"{n_tr:.0f} ({n_tr / 60:.1f}s)", f"{n_va:.0f} ({n_va / 60:.1f}s)",
                     f"{n_tr + n_va:.0f} ({(n_tr + n_va) / 60:.1f}s)"])
        total += n_tr + n_va
    rows.append(["TOTAL", "", "", f"{total:.0f} ({total / 60:.1f}s)"])
    return ascii_table(["Style", "Train frames", "Valid frames", "Total"], rows,
                       title="Data Info")
