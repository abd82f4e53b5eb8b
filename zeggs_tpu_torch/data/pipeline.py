"""Corpus preparation: raw BVH + WAV clips -> processed training data
(counterpart of `zeggs_tpu/data/pipeline.py`).

Per clip: load, silence non-speaker audio from the clip's timing CSV,
clap-timecode sync and trim, time-stretch augmentation (``len_ratios``),
audio and animation features; then the corpus statistics (per-dim means,
per-group scalar input stds, per-dim output stds) and the
processed_data.npz / stats.npz / data_definition.json artifacts, with the
per-style summary printed as a table and written as data_info.html.

Features run on ``device`` through `data/features.py`: on a card, every
clip's audio features are one launch of the mel kernel per augmentation.
Clips are independent: ``num_workers > 1`` maps them over a spawn pool
(each worker on the given device), and ``process_index``/``process_count``
shard the clip list into per-shard archives that `merge_shards` assembles
into the serial run's artifacts, bit for bit.

Debug artifacts, each behind its config flag, go to
``<processed>/normalized_animations``: ``save_normalized_animations``
writes each clip's root-relative and root-baked BVHs,
``visualize_gaze`` and ``visualize_spectrogram`` PNG plots (matplotlib,
imported by the plot functions only).
"""

from __future__ import annotations

import csv
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch
from scipy.interpolate import griddata

from ..config import PipelineConfig
from ..device import require_device
from ..io import bvh, checkpoint, wav
from ..ops import quat
from ..utils.logs import ascii_table
from . import features as F

_FEATURE_ORDER = (
    "root_pos", "root_rot", "root_vel", "root_vrt",
    "lpos", "ltxy", "lvel", "lvrt", "gaze_pos", "gaze_dir",
)


# ---------------------------------------------------------------------------
# timecode / silencing helpers
# ---------------------------------------------------------------------------

def timecode_to_thirds(tc, frames_scale):
    """'(H):(M):(S):(F)' -> 1/60-second "thirds"; audio timecodes are 30 fps
    (frame scale 2), animation 60 fps (scale 1)."""
    h, m, s, f = (int(x) for x in tc.rsplit(":"))
    return h * 216000 + m * 3600 + s * 60 + f * frames_scale


def speaker_mask(timing_rows, n_samples, fs):
    """Keep-mask over audio samples from speaker-timing rows ('#', 'Start',
    'End' as 'M:S.ms'): rows whose '#' holds an 'R' are kept."""
    mask = np.zeros(n_samples, np.float32)
    for row in timing_rows:
        if "R" not in str(row["#"]):
            continue

        def to_samples(val):
            minutes, seconds, ms = (int(x) for x in str(val).replace(".", ":").rsplit(":"))
            return minutes * 60 * fs + seconds * fs + int(ms * (fs / 1000))

        mask[to_samples(row["Start"]) : to_samples(row["End"])] = 1.0
    return mask


def sync_trim(anim_data, audio_data, info_row, audio_sr, anim_fps):
    """Clap-time sync, then trim both streams to the acting range."""
    audio_start = timecode_to_thirds(info_row["audio_start_time"], 2)
    anim_start = timecode_to_thirds(info_row["anim_start_time"], 1)
    act_start = timecode_to_thirds(info_row["acting_start_time"], 1)
    act_end = timecode_to_thirds(info_row["acting_end_time"], 1)

    a0 = int(np.round((act_start - audio_start) * (audio_sr / 60)))
    a1 = int(np.round((act_end - audio_start) * (audio_sr / 60)))
    m0 = int(np.round((act_start - anim_start) * (anim_fps / 60)))
    m1 = int(np.round((act_end - anim_start) * (anim_fps / 60)))
    if min(a0, a1, m0, m1) < 0:
        raise ValueError("The timings are incorrect!")
    anim_data = dict(anim_data)
    anim_data["rotations"] = anim_data["rotations"][m0:m1]
    anim_data["positions"] = anim_data["positions"][m0:m1]
    return anim_data, audio_data[a0:a1]


def time_stretch(anim_data, audio_data, len_ratio):
    """Cubic time-stretch of positions, unrolled quaternions and raw audio.
    The quaternion math runs in float32 on the host, as the reference's
    does."""
    if len_ratio == 1.0:
        return dict(anim_data), np.array(audio_data)
    anim = dict(anim_data)
    n = len(anim["rotations"])
    nbones = anim["positions"].shape[1]
    t_orig = np.linspace(0, n - 1, n)
    t_new = np.linspace(0, n - 1, int(len_ratio * n))
    anim["positions"] = griddata(
        t_orig, anim["positions"].reshape(n, -1), t_new, method="cubic"
    ).reshape(len(t_new), nbones, 3)
    euler = torch.as_tensor(np.radians(np.asarray(anim["rotations"], np.float32)))
    rots = quat.unroll(quat.from_euler(euler, anim["order"])).numpy()
    rots = griddata(t_orig, rots.reshape(n, -1), t_new, method="cubic").reshape(
        len(t_new), nbones, 4
    )
    rots = quat.normalize(torch.as_tensor(rots, dtype=torch.float32))
    anim["rotations"] = np.degrees(quat.to_euler(rots, order=anim["order"]).numpy())

    na = len(audio_data)
    ta_orig = np.linspace(0, na - 1, na)
    ta_new = np.linspace(0, na - 1, int(len_ratio * na))
    audio = griddata(ta_orig, np.asarray(audio_data), ta_new, method="cubic")
    return anim, audio.astype(np.float32)


# ---------------------------------------------------------------------------
# per-clip processing
# ---------------------------------------------------------------------------

def process_clip(anim_data, audio_data, conf: PipelineConfig, anim_fps=60, device="cuda"):
    """Features of one synced clip on ``device`` -> dict of float32 host
    arrays."""
    audio_features = F.preprocess_audio(
        audio_data, anim_fps, len(anim_data["rotations"]), conf.audio_conf,
        feature_type=tuple(conf.audio_feature_type), device=device,
    )
    feats = F.preprocess_animation(anim_data, device=device)
    out = {"audio_features": audio_features.cpu().numpy().astype(np.float32)}
    if len(out["audio_features"]) != len(anim_data["rotations"]):
        raise ValueError("audio and animation frame counts differ")
    if np.isnan(out["audio_features"]).any():
        raise ValueError("audio features hold NaN")
    for k in _FEATURE_ORDER:
        out[k] = getattr(feats, k).cpu().numpy().astype(np.float32)
    return out


def _process_one(args):
    (i, row, base, conf_dict, anim_fps, device) = args
    conf = PipelineConfig.from_dict(conf_dict)
    original_path = Path(base) / "original"
    anim_data = bvh.load(original_path / row["anim_bvh"])
    fps = int(np.ceil(1.0 / anim_data["frametime"]))
    if fps != anim_fps:
        raise ValueError(f"expected {anim_fps} fps, got {fps}")

    audio_file = original_path / row["audio_filename"]
    audio_sr, audio_data = wav.read_wavfile(
        audio_file, rescale=True, desired_fs=conf.audio_conf.sampling_rate,
    )
    timing_csv = audio_file.with_suffix(".csv")
    if timing_csv.exists():
        with open(timing_csv, newline="") as f:
            timing_rows = list(csv.DictReader(f))
        audio_data = audio_data * speaker_mask(timing_rows, len(audio_data), audio_sr)
    if row.get("audio_start_time"):
        anim_data, audio_data = sync_trim(anim_data, audio_data, row, audio_sr, anim_fps)

    results = []
    dbg = Path(base) / conf.processed_data_path / "normalized_animations"
    for len_ratio in conf.len_ratios:
        anim_i, audio_i = time_stretch(anim_data, audio_data, float(len_ratio))
        clip = process_clip(anim_i, audio_i, conf, anim_fps, device)
        name = f"{Path(row['anim_bvh']).stem}_x_{str(len_ratio).replace('.', '_')}"
        if conf.save_normalized_animations or conf.visualize_gaze:
            feats = F.preprocess_animation(anim_i, device=device)
            if conf.save_normalized_animations:
                save_normalized_animations(anim_i, feats, dbg, name)
            if conf.visualize_gaze:
                dbg.mkdir(parents=True, exist_ok=True)
                visualize_gaze(feats, dbg / f"{name}_gaze.png")
        if conf.visualize_spectrogram:
            dbg.mkdir(parents=True, exist_ok=True)
            visualize_spectrogram(clip["audio_features"], dbg / f"{name}_spec.png")
        results.append(dict(
            clip=clip,
            style=row["style"],
            validation=str(row.get("validation", "FALSE")).upper() in ("TRUE", "1"),
            len_ratio=float(len_ratio),
            name=name,
            anim=anim_i if conf.save_trimmed_animation else None,
            audio=audio_i if conf.save_trimmed_audio else None,
            skeleton=dict(
                parents=[int(p) for p in anim_data["parents"]],
                names=list(anim_data["names"]),
                dt=float(anim_data["frametime"]),
            ),
            index=i,
        ))
    return results


# ---------------------------------------------------------------------------
# corpus assembly
# ---------------------------------------------------------------------------

def compute_stats(processed, ranges_train):
    """Corpus statistics over frames 2..-2 of every training range: per-dim
    means; per-group scalar input stds; per-dim output stds; scalar audio
    std."""
    mask = np.zeros(len(processed["audio_features"]), dtype=bool)
    for s, e in ranges_train:
        mask[s + 2 : e - 2] = True
    if not mask.any():
        raise ValueError(
            "compute_stats: no training frames — every clip is marked validation (or the "
            "ranges are degenerate); cannot compute corpus statistics"
        )

    groups = ["root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt"]
    means = {k: processed[k][mask].mean(axis=0) for k in groups + ["gaze_dir"]}
    scalar_stds = {k: processed[k][mask].std() + 1e-10 for k in groups + ["gaze_dir"]}
    out_stds = {k: processed[k][mask].std(axis=0) for k in groups}

    anim_input_mean = np.hstack([means[k].ravel() for k in groups + ["gaze_dir"]])
    anim_input_std = np.hstack(
        [np.repeat(scalar_stds[k], means[k].size) for k in groups + ["gaze_dir"]]
    )
    anim_output_mean = np.hstack([means[k].ravel() for k in groups])
    anim_output_std = np.hstack([out_stds[k].ravel() for k in groups])
    return dict(
        audio_input_mean=processed["audio_features"][mask].mean(axis=0),
        audio_input_std=processed["audio_features"][mask].std() + 1e-10,
        anim_input_mean=anim_input_mean.astype(np.float32),
        anim_input_std=anim_input_std,
        anim_output_mean=anim_output_mean.astype(np.float32),
        anim_output_std=anim_output_std.astype(np.float32),
    )


def data_pipeline(conf, num_workers=None, process_index=0, process_count=1, device="cuda"):
    """Run the corpus pipeline with features on ``device`` (the card unless
    the caller asks for the CPU; raises without it).

    With ``process_count > 1`` this run takes the clips ``process_index::
    process_count`` and writes only ``pipeline_shard_<i>_of_<n>.npz``;
    `merge_shards` makes the final artifacts (global statistics, the serial
    clip order). Returns (processed_data, data_definition), or (None, None)
    for a shard."""
    if not isinstance(conf, PipelineConfig):
        conf = PipelineConfig.from_dict(dict(conf))
    device = str(require_device(device))
    base = Path(conf.base_path)
    out_path = base / conf.processed_data_path
    out_path.mkdir(parents=True, exist_ok=True)
    (out_path / "data_pipeline_conf.json").write_text(json.dumps(conf.to_dict(), indent=4))

    with open(base / conf.info_filename, newline="") as f:
        rows = list(csv.DictReader(f))
    # global row indices, so that shards merge back into the serial order
    tasks = [(i, row, str(base), conf.to_dict(), 60, device)
             for i, row in list(enumerate(rows))[process_index::process_count]]
    if num_workers and num_workers > 1:
        # spawn: a forked child must not inherit an initialised CUDA context
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx) as pool:
            nested = list(pool.map(_process_one, tasks))
    else:
        nested = [_process_one(t) for t in tasks]

    # clip order, then augmentation order
    all_clips = [c for clip_list in nested for c in clip_list]
    if process_count > 1:
        _save_shard(out_path, all_clips, process_index, process_count)
        return None, None
    return _assemble(all_clips, conf, out_path)


def _save_shard(out_path, all_clips, process_index, process_count):
    """This shard's clips: arrays in a flattened .npz, per-clip metadata in
    its JSON meta blob."""
    tree = {str(j): dict(c["clip"]) for j, c in enumerate(all_clips)}
    meta = [
        dict(style=c["style"], validation=bool(c["validation"]), len_ratio=c["len_ratio"],
             name=c["name"], index=int(c["index"]), skeleton=c["skeleton"],
             has_anim=c["anim"] is not None, has_audio=c["audio"] is not None)
        for c in all_clips
    ]
    for j, c in enumerate(all_clips):
        if c["anim"] is not None:
            for k in ("rotations", "positions", "offsets"):
                tree[str(j)][f"__anim_{k}"] = np.asarray(c["anim"][k])
            meta[j]["anim_extra"] = dict(
                order=c["anim"]["order"], names=list(c["anim"]["names"]),
                parents=[int(p) for p in c["anim"]["parents"]],
                frametime=float(c["anim"]["frametime"]),
            )
        if c["audio"] is not None:
            tree[str(j)]["__audio"] = np.asarray(c["audio"])
    checkpoint.save(out_path / f"pipeline_shard_{process_index}_of_{process_count}.npz",
                    tree, meta)


def merge_shards(conf, process_count):
    """Assemble ``process_count`` shard archives into the final artifacts,
    clips in their info.csv order, so that they equal a serial run's bit for
    bit (statistics are computed over the merged corpus, never per shard)."""
    if not isinstance(conf, PipelineConfig):
        conf = PipelineConfig.from_dict(dict(conf))
    out_path = Path(conf.base_path) / conf.processed_data_path
    entries = []
    for i in range(process_count):
        tree, meta = checkpoint.load(out_path / f"pipeline_shard_{i}_of_{process_count}.npz")
        for j, m in enumerate(meta):
            clip = dict(tree[str(j)])
            anim = audio = None
            if m.get("has_audio"):
                audio = clip.pop("__audio")
            if m.get("has_anim"):
                extra = m["anim_extra"]
                anim = dict(
                    rotations=clip.pop("__anim_rotations"),
                    positions=clip.pop("__anim_positions"),
                    offsets=clip.pop("__anim_offsets"),
                    order=extra["order"], names=extra["names"],
                    parents=extra["parents"], frametime=extra["frametime"],
                )
            entries.append(dict(
                clip=clip, style=m["style"], validation=m["validation"],
                len_ratio=m["len_ratio"], name=m["name"], index=m["index"],
                skeleton=m["skeleton"], anim=anim, audio=audio,
                _aug=j,  # within a shard, a clip's augmentations are in order
            ))
    entries.sort(key=lambda c: (c["index"], c["_aug"]))
    return _assemble(entries, conf, out_path)


def _assemble(all_clips, conf, out_path):
    """Corpus, statistics and the final artifacts (the serial path and the
    shard merge)."""
    keys = ("audio_features",) + _FEATURE_ORDER
    accum = {k: [] for k in keys}
    ranges_train, ranges_valid = [], []
    labels_train, labels_valid = [], []
    cursor = 0
    for c in all_clips:
        clip = c["clip"]
        n = len(clip["audio_features"])
        for k in keys:
            accum[k].append(clip[k])
        if c["validation"]:
            ranges_valid.append([cursor, cursor + n])
            labels_valid.append(c["style"])
        else:
            ranges_train.append([cursor, cursor + n])
            labels_train.append(c["style"])
        cursor += n
        folder = out_path / "trimmed" / ("valid" if c["validation"] else "train")
        if conf.save_trimmed_audio and c["audio"] is not None:
            folder.mkdir(parents=True, exist_ok=True)
            wav.write_wavefile(folder / (c["name"] + ".wav"), c["audio"],
                               conf.audio_conf.sampling_rate)
        if conf.save_trimmed_animation and c["anim"] is not None:
            folder.mkdir(parents=True, exist_ok=True)
            bvh.save(folder / (c["name"] + ".bvh"), c["anim"])

    label_names = sorted(set(labels_train + labels_valid))
    processed = {k: np.concatenate(v, axis=0).astype(np.float32) for k, v in accum.items()}
    ranges_train = np.asarray(ranges_train, np.int32).reshape(-1, 2)
    ranges_valid = np.asarray(ranges_valid, np.int32).reshape(-1, 2)

    common = dict(
        ranges_train=ranges_train,
        ranges_valid=ranges_valid,
        ranges_train_labels=np.asarray([label_names.index(l) for l in labels_train], np.int32),
        ranges_valid_labels=np.asarray([label_names.index(l) for l in labels_valid], np.int32),
        **compute_stats(processed, ranges_train),
    )
    processed_data = {
        "X_audio_features": processed["audio_features"],
        **{f"Y_{k}": processed[k] for k in _FEATURE_ORDER if k != "gaze_dir"},
        **common,
    }
    skel = all_clips[0]["skeleton"]
    data_definition = dict(dt=skel["dt"], label_names=label_names, parents=skel["parents"],
                           bone_names=skel["names"])
    if conf.save_final_data:
        np.savez(out_path / "processed_data.npz", **processed_data)
        np.savez(out_path / "stats.npz", **common)
        (out_path / "data_definition.json").write_text(json.dumps(data_definition, indent=4))

    summary = dataset_summary(label_names, ranges_train, common["ranges_train_labels"],
                              ranges_valid, common["ranges_valid_labels"])
    print(format_summary_ascii(summary))
    (out_path / "data_info.html").write_text(format_summary_html(summary, conf.to_dict()))
    return processed_data, data_definition


# ---------------------------------------------------------------------------
# dataset summary
# ---------------------------------------------------------------------------

def dataset_summary(label_names, ranges_train, ranges_train_labels, ranges_valid,
                    ranges_valid_labels):
    """Per-style train/valid frame counts, halved as the reference's table
    halves them (it counts each clip once despite the two stretches)."""
    def frames(ranges, labels, i):
        r = np.asarray(ranges).reshape(-1, 2)[np.asarray(labels) == i]
        return float(np.sum(r[:, 1] - r[:, 0])) / 2 if len(r) else 0.0

    per_style = []
    for i, name in enumerate(label_names):
        tr = frames(ranges_train, ranges_train_labels, i)
        va = frames(ranges_valid, ranges_valid_labels, i)
        per_style.append(dict(style=name, train=tr, valid=va, total=tr + va))
    total = sum(s["total"] for s in per_style)
    return dict(per_style=per_style, total_frames=total, total_seconds=total / 60.0)


def _fmt(n):
    return f"{n:.0f} frames - {n / 60:.1f} secs"


def format_summary_ascii(summary):
    rows = [
        ["Train"] + [_fmt(s["train"]) for s in summary["per_style"]],
        ["Validation"] + [_fmt(s["valid"]) for s in summary["per_style"]],
        ["Total"] + [_fmt(s["total"]) for s in summary["per_style"]],
    ]
    headers = ["Dataset"] + [s["style"] for s in summary["per_style"]]
    return (
        f"{ascii_table(headers, rows, title='Data Info')}\nTotal length of dataset is "
        f"{summary['total_frames']:.0f} frames - {summary['total_seconds']:.1f} seconds"
    )


def format_summary_html(summary, conf_dict=None):
    """A self-contained data_info.html: the summary table and the config."""
    head = "".join(f"<th>{s['style']}</th>" for s in summary["per_style"])
    rows = []
    for label, key in (("Train", "train"), ("Validation", "valid"), ("Total", "total")):
        cells = "".join(f"<td>{_fmt(s[key])}</td>" for s in summary["per_style"])
        rows.append(f"<tr><td>{label}</td>{cells}</tr>")
    conf_html = f"<pre>{json.dumps(conf_dict, indent=2)}</pre>" if conf_dict is not None else ""
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'><title>Data Info</title>"
        "<style>table{border-collapse:collapse}td,th{border:1px solid #888;"
        "padding:4px 8px;font-family:monospace;font-size:13px}</style></head><body>"
        f"<h2>Data Info</h2><table><tr><th>Dataset</th>{head}</tr>{''.join(rows)}</table>"
        f"<p>Total length of dataset is {summary['total_frames']:.0f} frames - "
        f"{summary['total_seconds']:.1f} seconds</p>{conf_html}</body></html>"
    )


# ---------------------------------------------------------------------------
# debug artifacts
# ---------------------------------------------------------------------------

def save_normalized_animations(anim_data, feats, out_dir, name):
    """Write <name>_norm.bvh (joints relative to the root) and
    <name>_denorm.bvh (the root baked back into joint 0), for inspection.
    The quaternion math runs in float32 on the host."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    order = anim_data["order"]
    lpos, lrot = feats.lpos.float().cpu(), feats.lrot.float().cpu()
    root_pos, root_rot = feats.root_pos.float().cpu(), feats.root_rot.float().cpu()

    norm = dict(anim_data)
    norm["positions"] = lpos.numpy()
    norm["rotations"] = np.degrees(quat.to_euler(lrot, order=order).numpy())
    bvh.save(out_dir / f"{name}_norm.bvh", norm)

    lpos_d, lrot_d = lpos.clone(), lrot.clone()
    lpos_d[:, 0] = quat.mul_vec(root_rot, lpos[:, 0]) + root_pos
    lrot_d[:, 0] = quat.mul(root_rot, lrot[:, 0])
    denorm = dict(anim_data)
    denorm["positions"] = lpos_d.numpy()
    denorm["rotations"] = np.degrees(quat.to_euler(lrot_d, order=order).numpy())
    bvh.save(out_dir / f"{name}_denorm.bvh", denorm)


def visualize_gaze(feats, out_path):
    """Top-down scatter of the root trajectory and the gaze target, as PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    root_pos = feats.root_pos.float().cpu().numpy()
    gaze_pos = feats.gaze_pos.float().cpu().numpy()
    fig, ax = plt.subplots()
    ax.scatter(root_pos[:, 0], root_pos[:, 2], s=0.2, marker=".", label="root")
    ax.scatter(gaze_pos[0, 0], gaze_pos[0, 2], marker="*", s=80, label="gaze target")
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)


def visualize_spectrogram(audio_features, out_path):
    """Heat map of a clip's (T, features) audio feature matrix, as PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(np.asarray(audio_features).T, interpolation="nearest", aspect="auto",
              origin="lower")
    ax.set_xlabel("frame")
    ax.set_ylabel("feature")
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
