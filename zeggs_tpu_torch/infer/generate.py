"""Gesture generation: speech audio + style -> BVH animation (counterpart of
`zeggs_tpu/infer/generate.py`).

Styles are BVH examples, raw embedding vectors or label names; several
styles blend by a weighted sum ("add") or by per-frame ranges ("stitch");
a first pose may be given; the VAE temperature and the seed control the
style draw. `GesturePipeline` loads networks and statistics once onto one
device and serves requests there; at B=1 on a card the decoder rollout is
one launch of the CUDA kernel. The batched entry points used by
`infer/batch.py` (`encode_speech_batched`, `encode_styles_batch`,
`rollout_batch`) live here too, and `streaming_session` opens an
`infer/streaming.py` session.
"""

from __future__ import annotations

import os
from pathlib import Path
from shutil import copyfile

import numpy as np
import torch

from ..config import DataDefinition, Options, load_pipeline_conf
from ..data import features as F
from ..device import require_device
from ..io import bvh, wav, weights
from ..models import decoder, pose
from ..models.decoder import Decoder
from ..models.speech_encoder import SpeechEncoder
from ..models.style_encoder import StyleEncoder
from ..ops import quat, xform
from ..ops.kernels import build
from ..utils import split_by_ratio, write_bvh
from .streaming import StreamingSession

_ROLLOUT_WEIGHTS = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}
#: batch size from which batched rollouts run int8 products when int8 is
#: selected (below it the per-step quantization is not amortized)
INT8_BATCHED_MIN = 256
#: featurized style examples a pipeline keeps
STYLE_CACHE = 128
_STATE0 = ("root_pos", "root_rot", "root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt")


class GesturePipeline:
    """Loads networks and statistics once and serves generation requests on
    ``device``, which it never leaves."""

    def __init__(self, network_path, data_path, options=None, style_encoding_type="example",
                 device="cuda", rollout_weights=None):
        """rollout_weights: dtype of the decoder weights in the B=1 CUDA
        kernel: "bfloat16" (37 MB streamed per frame; the default), "float32"
        or "int8" (18 MB, one scale per weight row, activations quantized
        every step). None takes "int8" when the environment sets
        ZEGGS_FUSED_INT8, else "bfloat16".

        B=1 rollouts run the kernel on a card. On the CPU they run the
        eager rollout, except with "int8", where the kernel's plain PyTorch
        version runs on the int8 packing: the CPU takes the plain version of
        each kernel. With "int8", batched rollouts of at least
        INT8_BATCHED_MIN rows run their products on int8 values."""
        if rollout_weights is None:
            rollout_weights = "int8" if os.environ.get("ZEGGS_FUSED_INT8") else "bfloat16"
        if rollout_weights not in _ROLLOUT_WEIGHTS:
            raise ValueError(f"rollout_weights must be one of {sorted(_ROLLOUT_WEIGHTS)}")
        self.device = require_device(device)
        if self.device.type == "cuda":
            # every kernel is built now, not at its first launch, which may
            # come on a serving thread
            build.build_all()
        network_path, data_path = Path(network_path), Path(data_path)
        self.style_encoding_type = style_encoding_type
        self.opts = options or Options()

        dd = DataDefinition.from_json(data_path / "data_definition.json")
        self.parents = np.asarray(dd.parents, np.int32)
        self.bone_names = list(dd.bone_names)
        self.label_names = list(dd.label_names)
        self.dt = dd.dt
        self.njoints = len(self.bone_names)
        self.mel_cfg, self.audio_feature_type = load_pipeline_conf(
            data_path / "data_pipeline_conf.json"
        )
        with np.load(data_path / "stats.npz") as stats:
            self.stats = {
                k: torch.as_tensor(np.asarray(stats[k], np.float32), device=self.device)
                for k in stats.files
            }
        self.networks = self._load_networks(network_path)
        self._style_cache = {}

        dec_cfg = self.opts.net.decoder
        self.rollout_weights = rollout_weights
        weights_dtype = _ROLLOUT_WEIGHTS[rollout_weights]
        self._quantize_batched = rollout_weights == "int8" and dec_cfg.rnn_cond == "normal"
        self._fused_fn = None
        if (self.device.type == "cuda" or rollout_weights == "int8") and decoder.fused_b1_supported(
            self.networks["decoder"], dec_cfg.rnn_cond, dec_cfg.num_rnn_layers, weights_dtype
        ):
            self._fused_fn = decoder.make_fused_b1_fn(
                self.networks["decoder"], self.stats["anim_input_mean"],
                self.stats["anim_input_std"], self.stats["anim_output_mean"],
                self.stats["anim_output_std"], self.dt, weights_dtype=weights_dtype,
            )

    # -- loading ----------------------------------------------------------

    def _load_networks(self, network_path):
        needed = ["speech_encoder", "decoder"]
        if self.style_encoding_type == "example":
            needed.append("style_encoder")
        missing = [n for n in needed if not (network_path / f"{n}.npz").exists()]
        if missing:
            raise FileNotFoundError(
                f"missing native .npz networks in {network_path}: {missing} "
                "(loading the reference's .pt checkpoints is not ported yet)"
            )
        nets = {}
        for name in needed:
            params = weights.load_jax_npz(network_path / f"{name}.npz")
            module = self._build_network(name, params)
            module.load_state_dict(weights.from_jax(params), strict=True)
            nets[name] = module.to(self.device).eval()
        return nets

    def _build_network(self, name, params):
        """An empty module of the checkpoint's widths on the pipeline's device."""
        dev = self.device
        if name == "speech_encoder":
            _, n_in, hidden = params["conv0"]["w"].shape
            return SpeechEncoder(n_in, hidden, params["conv1"]["w"].shape[2], device=dev)
        if name == "style_encoder":
            se_cfg = self.opts.net.style_encoder
            if se_cfg.type != "attn":
                raise NotImplementedError(f"style encoder {se_cfg.type!r} is not ported yet")
            _, n_in, hidden = params["body"]["conv0"]["w"].shape
            return StyleEncoder(n_in, hidden, se_cfg.style_encoding_size, se_cfg.use_vae,
                                device=dev)
        dec_cfg = self.opts.net.decoder
        cell = params["cell"]
        pose_in = self.stats["anim_input_mean"].shape[-1]
        style = params["cell_state_encoder"]["l0"]["w"].shape[0] - pose_in
        speech = cell["layer0"]["w"].shape[0] - pose_in - style
        return Decoder(pose_in, cell["out"]["w"].shape[1], speech, style,
                       cell["gru1"]["w_hh"].shape[0], dec_cfg.num_rnn_layers, dec_cfg.rnn_cond,
                       device=dev)

    # -- features and encoders ----------------------------------------------

    def audio_to_features(self, audio_file):
        """WAV -> ((n_frames, n_features) tensor on the device, n_frames)."""
        _, audio = wav.read_wavfile(audio_file, rescale=True,
                                    desired_fs=self.mel_cfg.sampling_rate,
                                    desired_nb_channels=None, out_type="float32")
        n_frames = int(round(60.0 * (len(audio) / self.mel_cfg.sampling_rate)))
        feats = F.preprocess_audio(audio, 60, n_frames, self.mel_cfg, self.audio_feature_type,
                                   device=self.device)
        return feats, n_frames

    def encode_speech(self, audio_features):
        return self.encode_speech_batched(audio_features[None])

    def encode_speech_batched(self, audio_features):
        """(B, T, n_features) -> (B, T, S) speech encodings."""
        x = (audio_features - self.stats["audio_input_mean"]) / self.stats["audio_input_std"]
        return self.networks["speech_encoder"](x)

    def style_example_from_bvh(self, path, frames=None):
        """BVH example -> (feature vec (L, pose_in), AnimFeatures). Cached by
        (path, mtime, frames), at most STYLE_CACHE entries, as the JAX
        pipeline caches it: requests reuse a few style clips, and the FK
        featurization is the costly part of a request. Callers must not
        modify the returned tensors."""
        key = (str(path), Path(path).stat().st_mtime_ns, tuple(frames) if frames else None)
        hit = self._style_cache.get(key)
        if hit is not None:
            return hit
        anim = bvh.load(path)
        if frames is not None:
            anim["rotations"] = anim["rotations"][frames[0] : frames[1]]
            anim["positions"] = anim["positions"][frames[0] : frames[1]]
        fps = int(np.ceil(1.0 / anim["frametime"]))
        if fps != 60:
            raise ValueError(f"style example must be 60 fps, got {fps}")
        feats = F.preprocess_animation(anim, device=self.device)
        vec = pose.example_feature_vec(feats.root_vel, feats.root_vrt, feats.lpos, feats.ltxy,
                                       feats.lvel, feats.lvrt)
        if len(self._style_cache) >= STYLE_CACHE:
            self._style_cache.pop(next(iter(self._style_cache)))
        self._style_cache[key] = hit = (vec, feats)
        return hit

    def encode_style(self, example_vec, temperature=1.0, generator=None):
        """Encode an (L, pose_in) example at its own length -> (embedding,
        mu, logvar), each (1, C). Temperature <= 0 gives mu."""
        x = (example_vec - self.stats["anim_input_mean"]) / self.stats["anim_input_std"]
        stochastic = temperature > 0.0
        return self.networks["style_encoder"](
            x[None], temperature=temperature if stochastic else 1.0,
            generator=generator if stochastic else None,
        )

    def encode_styles_batch(self, jobs):
        """Encode many style examples, one batched call per 64-frame length
        bucket (counterpart of the JAX pipeline's `encode_styles_batch`).

        jobs: list of (vec (L, pose_in), temperature, torch.Generator).
        Returns one (1, C) encoding per job. The encoder gives mu and logvar
        of the length-masked batch; then, job by job in order, eps of shape
        (1, C) is drawn from that job's generator where the temperature is
        above 0, so a request whose styles share one generator gets the
        draws `generate_gesture` makes for the same seed and styles."""
        if not jobs:
            return []
        buckets = {}
        for i, (vec, _, _) in enumerate(jobs):
            buckets.setdefault(max(64, -(-vec.shape[0] // 64) * 64), []).append(i)
        mu, logvar = [None] * len(jobs), [None] * len(jobs)
        encoder = self.networks["style_encoder"]
        for Lb, idxs in sorted(buckets.items()):
            D = jobs[idxs[0]][0].shape[1]
            padded = torch.zeros((len(idxs), Lb, D), device=self.device)
            lengths = torch.tensor([jobs[i][0].shape[0] for i in idxs], device=self.device)
            for j, i in enumerate(idxs):
                padded[j, : jobs[i][0].shape[0]] = jobs[i][0]
            x = (padded - self.stats["anim_input_mean"]) / self.stats["anim_input_std"]
            enc, m, lv = encoder(x, lengths=lengths)
            for j, i in enumerate(idxs):
                mu[i] = (enc if m is None else m)[j : j + 1]
                logvar[i] = None if lv is None else lv[j : j + 1]
        out = []
        for (_, temperature, generator), m, lv in zip(jobs, mu, logvar):
            if lv is None or temperature <= 0.0:
                out.append(m)
                continue
            std = torch.exp(0.5 * lv) / temperature
            eps = torch.randn(std.shape, generator=generator, device=std.device, dtype=std.dtype)
            out.append(m + eps * std)
        return out

    def label_encoding(self, label):
        one_hot = torch.zeros((1, len(self.label_names)), device=self.device)
        one_hot[0, self.label_names.index(label)] = 1.0
        return one_hot

    # -- rollout ------------------------------------------------------------

    def rollout(self, first_pose_feats, gaze_pos, speech_enc, style_enc):
        """Rollout from frame 0 of ``first_pose_feats`` under (1, T, ...)
        conditioning -> (root_pos, root_rot, lpos, lrot) trajectories
        (1, T, ...), joint rotations as quaternions."""
        state0 = tuple(getattr(first_pose_feats, k)[0:1] for k in _STATE0)
        return self.rollout_batch(state0, gaze_pos, speech_enc, style_enc)

    def rollout_batch(self, state0, gaze_pos, speech_enc, style_enc):
        """Rollout of B clips from their frame-0 states (8 tensors (B, ...),
        the order of `decoder.rollout`) under (B, T, ...) conditioning ->
        (root_pos, root_rot, lpos, lrot) trajectories (B, T, ...). B=1 takes
        the decoder kernel where the pipeline has one; larger batches run
        the eager rollout, with GRU1 through the GRU-cell kernel on a card."""
        B = speech_enc.shape[0]
        if self._fused_fn is not None and B == 1:
            out = self._fused_fn(state0, gaze_pos, speech_enc, style_enc)
            out = tuple(out[i] for i in (0, 1, 4, 5))
        else:
            s = self.stats
            out = decoder.rollout(
                self.networks["decoder"], *state0, gaze_pos, speech_enc, style_enc,
                s["anim_input_mean"], s["anim_input_std"], s["anim_output_mean"],
                s["anim_output_std"], self.dt, output_indices=(0, 1, 4, 5),
                quantize_int8=self._quantize_batched and B >= INT8_BATCHED_MIN,
            )
        lrot = quat.from_xform(xform.orthogonalize_from_xy(out[3]))
        return out[:3] + (lrot,)

    def streaming_session(self, styles, first_pose=None, blend_ratio=(0.5, 0.5),
                          temperature=1.0, seed=1234, gain=1.0, quantum=1):
        """Open a `StreamingSession`: push audio chunks, pull gesture frames
        as they become computable (see infer/streaming.py); it emits the
        offline frames."""
        return StreamingSession(
            self, styles, first_pose=first_pose, blend_ratio=blend_ratio,
            temperature=temperature, seed=seed, gain=gain, quantum=quantum,
        )

    def write_result(self, results_path, file_name, rollout_out, audio_file=None):
        results_path = Path(results_path)
        results_path.mkdir(exist_ok=True, parents=True)
        root_pos, root_rot, lpos, lrot = (t[0].float().cpu().numpy() for t in rollout_out)
        out_file = results_path / (file_name + ".bvh")
        write_bvh(str(out_file), root_pos, root_rot, lpos, lrot, parents=self.parents,
                  names=self.bone_names, order="zyx", dt=self.dt,
                  start_position=np.array([0.0, 0.0, 0.0]),
                  start_rotation=np.array([1.0, 0.0, 0.0, 0.0]))
        if audio_file is not None:
            copyfile(audio_file, results_path / (file_name + ".wav"))
        return out_file


@torch.inference_mode()
def generate_gesture(audio_file, styles, network_path, data_path, results_path,
                     style_encoding_type="example", blend_type="add", blend_ratio=(0.5, 0.5),
                     file_name=None, first_pose=None, temperature=1.0, seed=1234,
                     pipeline=None, device="cuda"):
    """Generate stylised gesture from audio and a style spec; writes
    <file_name>.bvh (and the .wav) under ``results_path``. ``device`` is
    used only when no ``pipeline`` is given. Returns the final style
    encoding: (1, C) for "add", (1, T, C) for "stitch", or the per-style
    list when ``audio_file`` is None with "stitch"."""
    pipe = pipeline or GesturePipeline(network_path, data_path,
                                       style_encoding_type=style_encoding_type, device=device)
    dev = pipe.device
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    if (audio_file is None) != (results_path is None):
        raise ValueError("audio_file and results_path are given together or not at all")

    speech_enc = n_frames = None
    if audio_file is not None:
        audio_features, n_frames = pipe.audio_to_features(audio_file)
        speech_enc = pipe.encode_speech(audio_features)

    style_encodings = []
    anim_name = last_feats = None
    for style in styles:
        if style_encoding_type == "example":
            if isinstance(style, (tuple, list)) and isinstance(style[0], (str, Path)):
                anim_name = Path(style[0]).stem
                vec, last_feats = pipe.style_example_from_bvh(style[0], style[1])
                emb, _, _ = pipe.encode_style(vec, temperature, generator)
                style_encodings.append(emb)
            elif isinstance(style, (tuple, list)) and isinstance(style[0], np.ndarray):
                anim_name = style[1]
                style_encodings.append(torch.as_tensor(style[0], dtype=torch.float32, device=dev)[None])
            elif isinstance(style, np.ndarray):
                style_encodings.append(torch.as_tensor(style, dtype=torch.float32, device=dev)[None])
            else:
                raise ValueError(f"bad style spec {style!r}")
        elif style_encoding_type == "label":
            if first_pose is None:
                raise ValueError("label styles require first_pose")
            anim_name = style
            style_encodings.append(pipe.label_encoding(style))
        else:
            raise ValueError(f"unknown style encoding type {style_encoding_type!r}")

    if blend_type == "stitch":
        if len(style_encodings) > 1 and audio_file is None:
            final_style = style_encodings
        elif len(style_encodings) > 1:
            if len(styles) != len(blend_ratio):
                raise ValueError("stitch needs one blend ratio per style")
            ranges = split_by_ratio(n_frames, list(blend_ratio))
            final_style = torch.cat(
                [enc[:, None].expand(-1, r[1] - r[0], -1) for enc, r in zip(style_encodings, ranges)],
                dim=1,
            )
        else:
            final_style = style_encodings[0]
    elif blend_type == "add":
        if len(style_encodings) > 1:
            if len(style_encodings) != len(blend_ratio):
                raise ValueError("add needs one blend ratio per style")
            stacked = torch.stack(style_encodings, dim=1)
            ratio = torch.as_tensor(blend_ratio, dtype=torch.float32, device=dev)
            final_style = torch.einsum("bnc,n->bc", stacked, ratio)
        else:
            final_style = style_encodings[0]
    else:
        raise ValueError(f"unknown blend type {blend_type!r}")

    if audio_file is None:
        return final_style

    if first_pose is not None:
        anim = bvh.load(first_pose) if isinstance(first_pose, (str, Path)) else dict(first_pose)
        feats0 = F.preprocess_animation(anim, device=dev)
    else:
        feats0 = last_feats
        if feats0 is None:
            raise ValueError("no first pose available: give first_pose or a BVH style example")

    gaze = feats0.gaze_pos[0].expand(n_frames, 3)[None]
    style_t = final_style if final_style.ndim == 3 else final_style[:, None].expand(-1, n_frames, -1)
    out = pipe.rollout(feats0, gaze, speech_enc, style_t.contiguous())

    if file_name is None:
        file_name = f"audio_{Path(audio_file).stem}_label_{anim_name}"
    pipe.write_result(results_path, file_name, out, audio_file)
    return final_style
