"""Gesture generation: speech audio + style -> BVH animation (counterpart of
`zeggs_tpu/infer/generate.py`).

Styles are BVH examples, raw embedding vectors or label names; several
styles blend by a weighted sum ("add") or by per-frame ranges ("stitch");
a first pose may be given; the VAE temperature and the seed control the
style draw. `GesturePipeline` loads networks and statistics once onto one
device and serves requests there; at B=1 on a card the decoder rollout is
one launch of the CUDA kernel, and larger batches replay CUDA graphs of the
decoder step from the pipeline's program cache (`infer/programs.py`, the
counterpart of `zeggs_tpu`'s ``_rollout_fn`` cache). A rollout's output
stage converts the joint rotations to quaternions and casts the four
trajectories to the pipeline's transfer dtype on the device, inside the
programs for batched chunks (`programs.output_stage`). The BVH's channels
(`utils.bvh_channels`: the upcast to float32, re-anchoring, root baking,
Euler degrees) are computed from them on the host by `write_result`, for
B=1 generation and streaming sessions, and on the device by
`infer.batch.generate_batch`, whose writers take the channels to
`write_channels`, which only formats and writes. The batched entry
points used by `infer/batch.py` (`encode_speech_batched`,
`encode_styles_batch`, `rollout_batch`) live here too, with
`GesturePipeline.replica`, which puts the speech encoder and the decoder
(with a program cache of its own) on another device of a mesh, and
`streaming_session` opens an `infer/streaming.py` session.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from pathlib import Path
from shutil import copyfile

import numpy as np
import torch

from ..config import DataDefinition, Options, load_pipeline_conf
from ..data import features as F
from ..device import require_device
from ..io import bvh, torch_compat, wav, weights
from ..models import decoder, pose
from ..models.decoder import Decoder
from ..models.speech_encoder import SpeechEncoder
from ..models.style_encoder import StyleEncoder
from ..ops.kernels import build
from ..utils import profiling, save_channels, split_by_ratio, write_bvh
from .programs import ProgramCache, output_stage
from .streaming import StreamingSession

_ROLLOUT_WEIGHTS = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}
#: the transfer dtypes of a rollout's outputs, by the names `zeggs_tpu`'s
#: ``jnp.dtype`` reads for them
TRANSFER_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32}
#: batch size from which batched rollouts run int8 products when int8 is
#: selected (below it the per-step quantization is not amortized)
INT8_BATCHED_MIN = 256
#: featurized style examples a pipeline keeps
STYLE_CACHE = 128
_STATE0 = ("root_pos", "root_rot", "root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt")


def build_network(name, params, opts: Options, pose_input_size, device):
    """The network ``name`` of a checkpoint (a JAX-layout tree) at the tree's
    widths, on ``device``, for inference: eval mode, no gradients. The
    style encoder's body type, VAE head and embedding size come from
    ``opts``, as the JAX package reads them."""
    if name == "speech_encoder":
        _, n_in, hidden = params["conv0"]["w"].shape
        module = SpeechEncoder(n_in, hidden, params["conv1"]["w"].shape[2], device=device)
    elif name == "style_encoder":
        se_cfg = opts.net.style_encoder
        _, n_in, hidden = params["body"]["conv0"]["w"].shape
        module = StyleEncoder(n_in, hidden, se_cfg.style_encoding_size, se_cfg.use_vae,
                              encoder_type=se_cfg.type, device=device)
    else:
        dec_cfg = opts.net.decoder
        cell = params["cell"]
        style = params["cell_state_encoder"]["l0"]["w"].shape[0] - pose_input_size
        # layer0 takes [pose | speech | style], or [pose | speech] in the film cell
        speech = (cell["layer0"]["w"].shape[0] - pose_input_size
                  - (0 if "gammas" in cell else style))
        module = Decoder(pose_input_size, cell["out"]["w"].shape[1], speech, style,
                         cell["gru1"]["w_hh"].shape[0], dec_cfg.num_rnn_layers,
                         dec_cfg.rnn_cond, device=device)
    module.load_state_dict(weights.from_jax(params), strict=True)
    # inference: autograd never records on these networks
    return module.to(device).eval().requires_grad_(False)


def transfer_dtype_of(name):
    """The torch dtype of a transfer dtype name: None or "" read
    ZEGGS_TRANSFER_DTYPE, as `zeggs_tpu` does, and float32 when it is unset
    too; another name than those of TRANSFER_DTYPES raises."""
    name = name or os.environ.get("ZEGGS_TRANSFER_DTYPE") or "float32"
    if name not in TRANSFER_DTYPES:
        raise ValueError(f"transfer_dtype must be one of {sorted(TRANSFER_DTYPES)}, not {name!r}")
    return TRANSFER_DTYPES[name]


@dataclasses.dataclass(frozen=True)
class Replica:
    """What a batched rollout runs on one device: the speech encoder and the
    decoder (``networks``), the statistics, the frame time, the decoder's
    program cache and the transfer dtype of the rollout's outputs."""

    device: torch.device
    networks: dict
    stats: dict
    dt: float
    programs: ProgramCache
    transfer_dtype: torch.dtype = torch.float32

    def encode_speech_batched(self, audio_features):
        """(B, T, n_features) -> (B, T, S) speech encodings."""
        x = (audio_features - self.stats["audio_input_mean"]) / self.stats["audio_input_std"]
        return self.networks["speech_encoder"](x)

    def rollout(self, state0, gaze_pos, speech_enc, style_enc, quantize_int8=False, slot=0):
        """The rollout of B clips (see `GesturePipeline.rollout_batch`)
        through the program cache: on a card the decoder steps replay CUDA
        graphs, GRU1 of every step through the GRU-cell kernel, and the
        programs of ``slot`` are used by this call alone (a mesh gives each
        block its own); products on int8 values with ``quantize_int8``; the
        output stage (`programs.output_stage`) inside the programs; the
        ``normal`` and the ``film`` cell alike. Returns (root_pos, root_rot,
        lpos, lrot) (B, T, ...) in the transfer dtype."""
        return self.programs.rollout(state0, gaze_pos, speech_enc, style_enc, quantize_int8,
                                     slot, self.transfer_dtype)

    def bake(self, out):
        """A rollout's (root_pos, root_rot, lpos, lrot) (B, T, ...) on this
        replica's device -> its BVH channels (`programs.bake`: positions and
        Euler degrees, float32 (B, T, J, 3)), computed there by a bake
        program of the cache (a CUDA graph on a card)."""
        return self.programs.bake(out)


class GesturePipeline:
    """Loads networks and statistics once and serves generation requests on
    ``device``, which it never leaves; `replica` copies what a batched
    rollout needs to another device."""

    def __init__(self, network_path, data_path, options=None, style_encoding_type="example",
                 device="cuda", rollout_weights=None, transfer_dtype=None):
        """rollout_weights: dtype of the decoder weights in the B=1 CUDA
        kernel: "bfloat16" (37 MB streamed per frame; the default), "float32"
        or "int8" (18 MB, one scale per weight row, activations quantized
        every step). None takes "int8" when the environment sets
        ZEGGS_FUSED_INT8, else "bfloat16".

        transfer_dtype: dtype of the rollout outputs copied to the host,
        "float16" (half the bytes of "float32", at ~1e-3 relative pose
        error), "bfloat16" or "float32"; None reads ZEGGS_TRANSFER_DTYPE,
        and takes "float32" when it is unset. The cast runs on the device
        (inside the rollout programs for batched chunks), and `write_result`
        upcasts to float32 on the host. `infer.batch.generate_batch` upcasts
        on the device instead (`Replica.bake`) and copies the float32
        channels, so there the dtype rounds the output but halves no copy.

        B=1 rollouts of the ``normal`` cell run the kernel on a card. On
        the CPU they run the eager rollout, except with "int8", where the
        kernel's plain PyTorch version runs on the int8 packing: the CPU
        takes the plain version of each kernel. The ``film`` cell has no
        B=1 kernel: its B=1 rollouts replay the rollout programs, as its
        batched ones do. With "int8", batched rollouts of the ``normal`` cell
        of at least INT8_BATCHED_MIN rows run their products on int8
        values."""
        if rollout_weights is None:
            rollout_weights = "int8" if os.environ.get("ZEGGS_FUSED_INT8") else "bfloat16"
        if rollout_weights not in _ROLLOUT_WEIGHTS:
            raise ValueError(f"rollout_weights must be one of {sorted(_ROLLOUT_WEIGHTS)}")
        self.transfer_dtype = transfer_dtype_of(transfer_dtype)
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
        self.style_encoding_size = (len(self.label_names) if style_encoding_type == "label"
                                    else self.opts.net.style_encoder.style_encoding_size)
        self._style_cache = {}
        self._replicas = {}
        self.programs = ProgramCache(self.networks["decoder"], self.stats, self.dt)

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
        """Native `.npz` networks first; each one missing is filled from the
        directory's reference `.pt` checkpoints (`io/torch_compat.py`)."""
        needed = ["speech_encoder", "decoder"]
        if self.style_encoding_type == "example":
            needed.append("style_encoder")
        trees = {n: weights.load_jax_npz(network_path / f"{n}.npz") for n in needed
                 if (network_path / f"{n}.npz").exists()}
        if len(trees) < len(needed):
            for name, tree in torch_compat.load_reference_networks(
                    network_path, self.style_encoding_type, self.opts.net.decoder.rnn_cond).items():
                trees.setdefault(name, tree)
        missing = [n for n in needed if n not in trees]
        if missing:
            raise FileNotFoundError(f"missing network checkpoints in {network_path}: {missing}")
        nets = {}
        for name in needed:
            nets[name] = build_network(name, trees[name], self.opts,
                                       self.stats["anim_input_mean"].shape[-1], self.device)
        return nets

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
        return self.replica(self.device).encode_speech_batched(audio_features)

    def style_example_from_bvh(self, path, frames=None):
        """BVH example -> (feature vec (L, pose_in), AnimFeatures). Cached by
        (path, mtime, frames), at most STYLE_CACHE entries, as the JAX
        pipeline caches it: requests reuse a few style clips, and the FK
        featurization is the costly part of a request. Callers must not
        modify the returned tensors. Counts ``style_cache.hits`` and
        ``style_cache.misses``."""
        key = (str(path), Path(path).stat().st_mtime_ns, tuple(frames) if frames else None)
        hit = self._style_cache.get(key)
        if hit is not None:
            profiling.count("style_cache.hits")
            return hit
        profiling.count("style_cache.misses")
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
        (1, T, ...), joint rotations as quaternions, in the transfer dtype."""
        state0 = tuple(getattr(first_pose_feats, k)[0:1] for k in _STATE0)
        return self.rollout_batch(state0, gaze_pos, speech_enc, style_enc)

    def quantize_batched(self, B):
        """Whether an eager rollout of a chunk of B clips runs its products
        on int8 values."""
        return self._quantize_batched and B >= INT8_BATCHED_MIN

    def rollout_batch(self, state0, gaze_pos, speech_enc, style_enc):
        """Rollout of B clips from their frame-0 states (8 tensors (B, ...),
        the order of `decoder.rollout`) under (B, T, ...) conditioning ->
        (root_pos, root_rot, lpos, lrot) trajectories (B, T, ...) in the
        transfer dtype. B=1 takes the decoder kernel where the pipeline has
        one, as `zeggs_tpu`'s ``_rollout_fn`` takes its fused kernel at
        ``shape[0] == 1``, then the output stage, eagerly on the device;
        every other chunk runs the decoder step and the output stage from
        the pipeline's program cache (CUDA graphs on a card, GRU1 through the
        GRU-cell kernel)."""
        B = speech_enc.shape[0]
        if self._fused_fn is not None and B == 1:
            out = self._fused_fn(state0, gaze_pos, speech_enc, style_enc)
            return output_stage(tuple(out[i] for i in (0, 1, 4, 5)), self.transfer_dtype)
        return self.replica(self.device).rollout(
            state0, gaze_pos, speech_enc, style_enc, quantize_int8=self.quantize_batched(B))

    def replica(self, device):
        """The speech encoder, the decoder and the statistics on ``device``
        (a card by its index, as a mesh names it, or without one for the
        pipeline's; a `Replica`): on the pipeline's own device its own
        modules and program cache, else a copy made at the first
        call and kept, with a program cache of its own. A replica runs no
        B=1 decoder kernel: its packing stays with the pipeline."""
        device = torch.device(device)
        own = self.stats["anim_input_mean"].device
        if device == own or (device.type == own.type and device.index is None):
            return Replica(own, {n: self.networks[n] for n in ("speech_encoder", "decoder")},
                           self.stats, self.dt, self.programs, self.transfer_dtype)
        if device not in self._replicas:
            require_device(device)
            # plain tensors, also when called under inference mode: the copy
            # outlives the call
            with torch.inference_mode(False):
                nets = {n: copy.deepcopy(self.networks[n]).to(device)
                        for n in ("speech_encoder", "decoder")}
                stats = {k: v.to(device) for k, v in self.stats.items()}
            self._replicas[device] = Replica(device, nets, stats, self.dt,
                                             ProgramCache(nets["decoder"], stats, self.dt),
                                             self.transfer_dtype)
        return self._replicas[device]

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
        """Write (root_pos, root_rot, lpos, lrot) (1, T, ...), on the device or
        on the host in any transfer dtype, as <file_name>.bvh: pulled first,
        then the BVH's channels computed on the host in float32 (`write_bvh`,
        re-anchored to the origin and the identity rotation). B=1
        generation, streaming sessions and the daemon's stream writes take
        this path; `infer.batch.generate_batch` computes the channels on the
        device and writes them with `write_channels`."""
        results_path = Path(results_path)
        results_path.mkdir(exist_ok=True, parents=True)
        out_file = results_path / (file_name + ".bvh")
        write_bvh(str(out_file), *(t[0].cpu() for t in rollout_out), parents=self.parents,
                  names=self.bone_names, order="zyx", dt=self.dt,
                  start_position=np.array([0.0, 0.0, 0.0]),
                  start_rotation=np.array([1.0, 0.0, 0.0, 0.0]))
        if audio_file is not None:
            copyfile(audio_file, results_path / (file_name + ".wav"))
        return out_file

    def write_channels(self, results_path, file_name, positions, rotations, audio_file=None):
        """Write one clip's BVH channels, host arrays (T, J, 3) of positions
        and Euler degrees (order "zyx") as `utils.bvh_channels` computed
        them (re-anchored), as <file_name>.bvh, only formatted; then copy
        the .wav."""
        results_path = Path(results_path)
        results_path.mkdir(exist_ok=True, parents=True)
        out_file = results_path / (file_name + ".bvh")
        save_channels(str(out_file), positions, rotations, self.parents, self.bone_names,
                      order="zyx", dt=self.dt)
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
