"""The inputs a cell hands to the program and to the reference alike, made
from the run's seed: the weights, the training corpus, speech-like audio,
skeleton motions, and the files a pipeline loads (data definition, audio
configuration, statistics, `.npz` networks).

Weights and the corpus are drawn on the device by one `torch.Generator`, in
a few large calls. The skeleton and the motions are the port's bench
fixture's (`zeggs_tpu_torch/bench/fixture.py::_skeleton`, `_motion`): 75
joints whose first seven carry the names the featurizer resolves.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
from scipy.io import wavfile

from .common import seed_of
from .reference import bvh, model

#: the corpus tracks and their widths a frame (J joints)
TRACKS = ("audio_features", "root_pos", "root_rot", "root_vel", "root_vrt", "lpos", "ltxy",
          "lvel", "lvrt", "gaze_pos")


def _bound(module, name, param):
    """The half-width of a parameter's uniform draw: 1/sqrt(fan in), as
    PyTorch's default initialisation bounds a layer (a GRU by its hidden
    size; a bias by its weight's fan in)."""
    if isinstance(module, nn.GRUCell):
        return module.hidden_size ** -0.5
    weight = getattr(module, name.replace("bias", "weight"), None)
    shape = (weight if isinstance(weight, torch.Tensor) else param).shape
    fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
    return fan_in ** -0.5


def make_params(cfg, seed, device):
    """The networks' parameters ({"<network>.<parameter>": tensor}, float32
    on ``device``): one uniform draw over all of them from a generator
    seeded from ``seed``, each scaled by `_bound`; LayerNorm scales 1 and
    offsets 0."""
    nets = model.build_networks(cfg, "meta")
    specs = []
    for net_name, net in nets.items():
        for mod_name, module in net.named_modules():
            for name, p in module.named_parameters(recurse=False):
                full = f"{net_name}.{mod_name}.{name}" if mod_name else f"{net_name}.{name}"
                fill = ({"weight": 1.0, "bias": 0.0}[name] if isinstance(module, nn.LayerNorm)
                        else None)
                specs.append((full, tuple(p.shape), fill, _bound(module, name, p)))
    total = sum(int(np.prod(s)) for _, s, _, _ in specs)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed_of(seed, 1))
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=generator)
    params, at = {}, 0
    for full, shape, fill, bound in specs:
        n = int(np.prod(shape))
        view = flat[at : at + n].view(shape)
        if fill is None:
            view.mul_(bound)
        else:
            view.fill_(fill)
        params[full], at = view, at + n
    return params


def make_stats(cfg, seed):
    """The normalisation statistics (numpy): unit animation statistics, a
    unit audio deviation and a small random audio mean."""
    ds = cfg["dataset"]
    rng = np.random.default_rng(seed_of(seed, 2))
    return {
        "audio_input_mean": (rng.normal(size=ds["audio_features"]) * 0.1).astype(np.float32),
        "audio_input_std": np.float32(1.0),
        "anim_input_mean": np.zeros(ds["pose_input_size"], np.float32),
        "anim_input_std": np.ones(ds["pose_input_size"], np.float32),
        "anim_output_mean": np.zeros(ds["pose_output_size"], np.float32),
        "anim_output_std": np.ones(ds["pose_output_size"], np.float32),
    }


def stats_on(stats, device):
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in stats.items()}


# ---------------------------------------------------------------------------
# the training corpus
# ---------------------------------------------------------------------------

def track_shapes(njoints, n_audio=81):
    J = njoints
    return {"audio_features": (n_audio,), "root_pos": (3,), "root_rot": (4,), "root_vel": (3,),
            "root_vrt": (3,), "lpos": (J, 3), "ltxy": (J, 2, 3), "lvel": (J, 3),
            "lvrt": (J, 3), "gaze_pos": (3,)}


def make_corpus(n_frames, njoints, seed, device, n_audio=81):
    """The corpus tracks ({key: (n_frames, ...) float32 tensor} on
    ``device``), the distributions of the port's bench corpus: standard
    normal positions and features, unit root quaternions, velocities at a
    tenth."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed_of(seed, 3))
    out = {}
    for key, shape in track_shapes(njoints, n_audio).items():
        x = torch.randn((n_frames, *shape), generator=generator, device=device)
        if key == "root_rot":
            x /= torch.linalg.norm(x, dim=-1, keepdim=True)
        elif key in ("root_vel", "root_vrt", "lvel", "lvrt"):
            x *= 0.1
        out[key] = x
    return out


class CorpusIndex:
    """The window and example indexing of a corpus cut into ``takes``
    equal takes (the dataset-shaped object `DeviceCorpus` reads): every
    window of ``window`` frames inside a take, examples up to twice
    ``example_length`` wide."""

    def __init__(self, arrays, takes, window, example_length):
        n = next(iter(arrays.values())).shape[0]
        self.arrays = arrays
        self.window = window
        self.max_example_length = 2 * example_length
        cuts = np.linspace(0, n, takes + 1).astype(np.int64)
        self.ranges_train = np.stack([cuts[:-1], cuts[1:]], 1).astype(np.int32)
        starts = [np.arange(s, e - window) for s, e in self.ranges_train]
        self.window_starts = np.concatenate(starts)
        self.window_samples = np.concatenate(
            [np.full(len(s), i, np.int32) for i, s in enumerate(starts)])


# ---------------------------------------------------------------------------
# audio, skeletons and motions
# ---------------------------------------------------------------------------

def skeleton(njoints):
    """Names and parents: the featurizer's seven spine joints, then a bushy
    tree off them."""
    names = ["Hips", "Spine", "Spine1", "Spine2", "Spine3", "Neck", "Head"]
    parents = [-1, 0, 1, 2, 3, 4, 5]
    while len(names) < njoints:
        i = len(names)
        names.append(f"Joint{i}")
        parents.append((i - 1) % 7)
    return names, parents


def motion(nframes, seed, njoints):
    """A BVH dict of ``nframes`` frames: sinusoidal joint rotations of random
    phase and amplitude, a root walking along x at 95 cm height."""
    rng = np.random.default_rng(seed)
    names, parents = skeleton(njoints)
    t = np.linspace(0, 2 * np.pi, nframes)[:, None, None]
    phase = rng.uniform(0, 2 * np.pi, (1, njoints, 3))
    amp = rng.uniform(3, 20, (1, njoints, 3))
    rotations = (amp * np.sin(2 * t + phase)).astype(np.float32)
    offsets = rng.uniform(-8, 8, (njoints, 3)).astype(np.float32)
    offsets[0] = 0
    positions = np.repeat(offsets[None], nframes, axis=0).astype(np.float32)
    positions[:, 0, 1] += 95.0
    positions[:, 0, 0] += np.linspace(0, 20, nframes)
    return {"rotations": rotations, "positions": positions, "offsets": offsets,
            "parents": np.asarray(parents, np.int32), "names": names, "order": "zyx",
            "frametime": 1.0 / 60.0}


def speech_like(rng, n, fs=16000):
    """n samples of a voice-band tone of random pitch under a syllable-rate
    envelope, with noise, in [-1, 1)."""
    t = np.arange(n) / fs
    f0, rate = rng.uniform(100, 260), rng.uniform(2.5, 5.0)
    x = (0.3 * np.sin(2 * np.pi * f0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * rate * t))
         + 0.05 * rng.normal(size=n))
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def write_wav(path, samples, fs=16000):
    """16-bit PCM, as the dataset's clips."""
    wavfile.write(str(path), fs, np.round(np.asarray(samples) * 32767).astype(np.int16))


def read_wav(path):
    """A 16-bit WAV's samples as float32 in [-1, 1), as the port rescales
    them (x / 32768)."""
    _, x = wavfile.read(str(path))
    return (x / 32768.0).astype(np.float32)


def write_bvh(path, anim):
    bvh.save(str(path), anim)


def uniform_lengths(n, lo_s, hi_s):
    """n clip lengths in seconds: the quantiles (i + 0.5) / n of a uniform
    over [lo_s, hi_s]; every seed gets the same set, and draws only its
    order."""
    return lo_s + (hi_s - lo_s) * (np.arange(n) + 0.5) / n


def lognormal_lengths(n, median_s, sigma, lo_s, hi_s):
    """n clip lengths in seconds: the quantiles (i + 0.5) / n of a lognormal
    of this median and sigma, clipped to [lo_s, hi_s]; every seed gets the
    same set, and draws only its order."""
    from statistics import NormalDist

    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(median_s * np.exp(sigma * z), lo_s, hi_s)


# ---------------------------------------------------------------------------
# the files a pipeline loads
# ---------------------------------------------------------------------------

def write_pipeline_files(cfg, params, stats, root):
    """data_definition.json, data_pipeline_conf.json and stats.npz under
    ``root/data``, the networks as `.npz` under ``root/networks`` (the
    port's checkpoint format, written by the port's own converter) ->
    (networks dir, data dir)."""
    from zeggs_tpu_torch.io import checkpoint, weights

    ds = cfg["dataset"]
    data_dir, net_dir = Path(root) / "data", Path(root) / "networks"
    data_dir.mkdir(parents=True, exist_ok=True)
    net_dir.mkdir(parents=True, exist_ok=True)
    names, parents = skeleton(ds["njoints"])
    (data_dir / "data_definition.json").write_text(json.dumps({
        "dt": 1.0 / ds["fps"], "label_names": ds["styles"], "parents": parents,
        "bone_names": names}))
    (data_dir / "data_pipeline_conf.json").write_text(json.dumps({
        "audio_conf": cfg["audio_conf"], "audio_feature_type": cfg["audio_feature_type"]}))
    np.savez(data_dir / "stats.npz", **stats)
    nets = model.build_networks(cfg, "meta")
    for name, module in nets.items():
        values = {k[len(name) + 1:]: v for k, v in params.items() if k.startswith(name + ".")}
        checkpoint.save(net_dir / f"{name}.npz", weights.to_jax(module, values))
    return net_dir, data_dir


def reference_networks(cfg, params, device):
    """The reference's networks holding ``params``."""
    return model.load(model.build_networks(cfg, device), params)
