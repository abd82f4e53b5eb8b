"""Configuration files of a trained model, read without jax.

Counterparts of `zeggs_tpu/config.py` (options.json) and of
`zeggs_tpu/ops/mel.py::MelConfig` (the ``audio_conf`` block of
data_pipeline_conf.json), plus the data_definition.json reader that
`zeggs_tpu/infer/generate.py` inlines.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path


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
    type: str = "attn"  # or "gru"
    use_vae: bool = True


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    decoder: DecoderConfig = DecoderConfig()
    speech_encoder: SpeechEncoderConfig = SpeechEncoderConfig()
    style_encoder: StyleEncoderConfig = StyleEncoderConfig()


@dataclasses.dataclass(frozen=True)
class Options:
    """The ``net_opt`` part of options.json; the CLI reads ``paths`` from
    the file itself, and ``train_opt`` belongs to the trainer, which is not
    ported yet."""

    net: NetworkConfig = NetworkConfig()

    @classmethod
    def from_options_dict(cls, o):
        net_opt = o.get("net_opt", {})
        return cls(net=NetworkConfig(
            decoder=_pick(DecoderConfig, net_opt.get("decoder", {})),
            speech_encoder=_pick(SpeechEncoderConfig, net_opt.get("speech_encoder", {})),
            style_encoder=_pick(StyleEncoderConfig, net_opt.get("style_encoder", {})),
        ))


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
