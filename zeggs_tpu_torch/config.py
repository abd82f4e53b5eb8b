"""Configuration files, read without jax.

Counterparts of `zeggs_tpu/config.py` (options.json with its paths,
network and training blocks; data_pipeline_conf.json; the output-directory
layout) and of `zeggs_tpu/ops/mel.py::MelConfig` (the ``audio_conf`` block
of data_pipeline_conf.json), plus the data_definition.json reader that
`zeggs_tpu/infer/generate.py` inlines. Both packages read the same files to
the same values.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
from pathlib import Path
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """The reference ``audio_conf`` block (configs/data_pipeline_conf_v1.json)."""

    sampling_rate: int = 16000
    filter_length: int = 800  # n_fft
    hop_length: int = 200
    n_mel_channels: int = 80
    mel_fmin: float = 20.0
    mel_fmax: float = 7600.0
    min_clipping: float = 1e-5
    pre_emphasis: bool = False
    pre_emph_coeff: float = 0.97
    centered: bool = True
    real_amplitude: bool = True
    normalize_mel_bins: bool = True
    normalize_range: bool = True
    resample_method: str = "linear"
    normalize_loudness: bool = True

    @classmethod
    def from_dict(cls, d):
        return _pick(cls, d)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    nhidden: int = 1024
    num_rnn_layers: int = 2
    rnn_cond: str = "normal"  # or "film"


@dataclasses.dataclass(frozen=True)
class SpeechEncoderConfig:
    nhidden: int = 64
    speech_encoding_size: int = 64


@dataclasses.dataclass(frozen=True)
class StyleEncoderConfig:
    nhidden: int = 512
    style_encoding_size: int = 64
    example_length: int = 256
    type: str = "attn"  # or "gru"
    use_vae: bool = True


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    decoder: DecoderConfig = DecoderConfig()
    speech_encoder: SpeechEncoderConfig = SpeechEncoderConfig()
    style_encoder: StyleEncoderConfig = StyleEncoderConfig()


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    niterations: int = 160  # x1000 iterations
    batchsize: int = 32
    window: int = 256
    learning_rate: float = 1e-4
    learning_rate_decay: float = 0.995
    eps: float = 1e-5
    resume: bool = False
    seed: int = 1234
    style_encoding_type: str = "example"  # or "label"
    generate_samples_step: int = 5000
    use_tensorboard: bool = True
    # The JAX package's additions, read so that one options.json serves both
    # packages. ``mesh_data_axis`` (devices of the data axis) and ``unroll``
    # (the decoder scan's unroll) mean nothing to eager PyTorch on one card
    # and are ignored.
    mesh_data_axis: int = -1
    compute_dtype: str = "float32"  # dtype of the decoder's products in training
    remat: bool = False  # recompute decoder steps in the backward pass
    unroll: int = 4


@dataclasses.dataclass(frozen=True)
class PathsConfig:
    base_path: str = "./data"
    path_processed_data: str = "processed_v1"
    output_dir: Optional[str] = None
    models_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """configs/data_pipeline_conf_v*.json."""

    base_path: str = "./data"
    processed_data_path: str = "processed_v1"
    save_trimmed_audio: bool = True
    save_trimmed_animation: bool = True
    save_normalized_animations: bool = False
    save_final_data: bool = True
    info_filename: str = "info.csv"
    audio_conf: MelConfig = MelConfig()
    audio_feature_type: Sequence[str] = ("mel_spec", "energy")
    visualize_spectrogram: bool = False
    visualize_gaze: bool = False
    len_ratios: Sequence[float] = (0.9, 1.0)

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        if "audio_conf" in d:
            d["audio_conf"] = MelConfig.from_dict(d["audio_conf"])
        return _pick(cls, d)

    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["audio_feature_type"] = list(self.audio_feature_type)
        d["len_ratios"] = list(self.len_ratios)
        return d


@dataclasses.dataclass(frozen=True)
class Options:
    """options.json / configs_v*.json (keys: name, paths, net_opt,
    train_opt)."""

    name: str = "S2G"
    paths: PathsConfig = PathsConfig()
    net: NetworkConfig = NetworkConfig()
    train: TrainConfig = TrainConfig()

    @classmethod
    def from_options_json(cls, path):
        with open(path) as f:
            return cls.from_options_dict(json.load(f))

    @classmethod
    def from_options_dict(cls, o):
        net_opt = o.get("net_opt", {})
        return cls(
            name=o.get("name", "S2G"),
            paths=_pick(PathsConfig, o.get("paths") or {}),
            net=NetworkConfig(
                decoder=_pick(DecoderConfig, net_opt.get("decoder", {})),
                speech_encoder=_pick(SpeechEncoderConfig, net_opt.get("speech_encoder", {})),
                style_encoder=_pick(StyleEncoderConfig, net_opt.get("style_encoder", {})),
            ),
            train=_pick(TrainConfig, o.get("train_opt", {})),
        )

    def to_options_dict(self):
        """The options.json layout, as the JAX package writes it."""
        return {
            "name": self.name,
            "paths": dataclasses.asdict(self.paths),
            "net_opt": {
                "decoder": dataclasses.asdict(self.net.decoder),
                "speech_encoder": dataclasses.asdict(self.net.speech_encoder),
                "style_encoder": dataclasses.asdict(self.net.style_encoder),
            },
            "train_opt": dataclasses.asdict(self.train),
        }


def resolve_output_dirs(opts: Options, name: Optional[str] = None):
    """(output_dir, models_dir, logs_dir), created: base_path/outputs/<name
    or a timestamp> unless options.json sets output_dir; saved_models/ and
    logs/ under it unless it sets models_dir."""
    paths = opts.paths
    if paths.output_dir is None:
        stamp = name or datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
        output_dir = Path(paths.base_path) / "outputs" / stamp
    else:
        output_dir = Path(paths.output_dir)
    output_dir.mkdir(exist_ok=True, parents=True)
    models_dir = Path(paths.models_dir) if paths.models_dir else output_dir / "saved_models"
    models_dir.mkdir(exist_ok=True, parents=True)
    logs_dir = output_dir / "logs"
    logs_dir.mkdir(exist_ok=True, parents=True)
    return output_dir, models_dir, logs_dir


@dataclasses.dataclass(frozen=True)
class DataDefinition:
    """data_definition.json: the skeleton and the style labels."""

    parents: tuple
    bone_names: tuple
    label_names: tuple
    dt: float

    @classmethod
    def from_json(cls, path):
        with open(path) as f:
            d = json.load(f)
        return cls(
            parents=tuple(int(p) for p in d["parents"]),
            bone_names=tuple(d["bone_names"]),
            label_names=tuple(d["label_names"]),
            dt=float(d["dt"]),
        )


def load_pipeline_conf(path):
    """data_pipeline_conf.json -> (MelConfig, audio feature types)."""
    with open(Path(path)) as f:
        conf = json.load(f)
    mel_cfg = MelConfig.from_dict(conf.get("audio_conf", conf))
    return mel_cfg, tuple(conf.get("audio_feature_type", ("mel_spec", "energy")))


def _pick(dc, d):
    fields = {f.name for f in dataclasses.fields(dc)}
    return dc(**{k: v for k, v in d.items() if k in fields})
