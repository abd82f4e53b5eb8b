"""The plain reference of ZEGGS: its networks, its training step and its
inference, in plain PyTorch at float32, built from a configuration file
(`benchmark/configs/<name>.json`) and the weights the benchmark made.

Frozen copies of the port's plain code (`zeggs_tpu_torch/train/loop.py::
make_loss_fn`, `data/device_dataset.py::DeviceCorpus.gather_batch`,
`infer/generate.py`'s request path, `infer/programs.py::with_quaternions`
and `utils/__init__.py::write_bvh`'s re-anchoring), with no kernel, no CUDA
graph, no batching across requests and no cache. The random draws (dropout
masks, VAE noise) are made from generators the caller seeds, in the order
the port draws them, so that the same seed gives the same draws.
"""

from __future__ import annotations

import numpy as np
import torch

from . import decoder, features, quat, xform
from .loss import compute_loss
from .pose import example_feature_vec
from .radam import RAdam, exponential_step_schedule
from .speech_encoder import SpeechEncoder
from .style_encoder import StyleEncoder

POSE_KEYS = ("root_pos", "root_rot", "root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt")
WINDOW_KEYS = ("audio_features",) + POSE_KEYS + ("gaze_pos",)
EXAMPLE_KEYS = ("root_vel", "root_vrt", "lpos", "ltxy", "lvel", "lvrt")


def label_style(cfg):
    return cfg["train_opt"]["style_encoding_type"] == "label"


def build_networks(cfg, device="cpu"):
    """{name: module} of the configuration on ``device`` (``"meta"`` gives
    the shapes alone), parameters in the port's names and order."""
    net, ds = cfg["net_opt"], cfg["dataset"]
    se, dec, st = net["speech_encoder"], net["decoder"], net["style_encoder"]
    style = len(ds["styles"]) if label_style(cfg) else st["style_encoding_size"]
    nets = {
        "speech_encoder": SpeechEncoder(ds["audio_features"], se["nhidden"],
                                        se["speech_encoding_size"], device=device),
        "decoder": decoder.Decoder(ds["pose_input_size"], ds["pose_output_size"],
                                   se["speech_encoding_size"], style, dec["nhidden"],
                                   dec["num_rnn_layers"], device=device),
    }
    if not label_style(cfg):
        nets["style_encoder"] = StyleEncoder(ds["pose_input_size"], st["nhidden"],
                                             st["style_encoding_size"], st["use_vae"],
                                             encoder_type=st["type"], device=device)
    return nets


def named_parameters(nets):
    return {f"{n}.{k}": p for n, m in nets.items() for k, p in m.named_parameters()}


def load(nets, params):
    """Copy ``params`` ({"<network>.<parameter>": tensor}) into ``nets``."""
    with torch.no_grad():
        for name, p in named_parameters(nets).items():
            p.copy_(params[name])
    return nets


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def make_loss_fn(cfg, stats, parents, dt):
    """``loss_fn(nets, batch, iteration, generator)`` -> (loss, metrics), as
    the port's `make_loss_fn` at float32 without remat."""
    label = label_style(cfg)

    def loss_fn(nets, batch, iteration, generator):
        s = stats
        audio = (batch["audio_features"] - s["audio_input_mean"]) / s["audio_input_std"]
        speech = nets["speech_encoder"](audio, generator=generator)
        mu = logvar = None
        if label:
            style = batch["style"]
        else:
            ex = (batch["example"] - s["anim_input_mean"]) / s["anim_input_std"]
            style, mu, logvar = nets["style_encoder"](
                ex, lengths=batch["example_lengths"], generator=generator, train=True)
        T = speech.shape[1]
        outputs = decoder.rollout(
            nets["decoder"], *(batch[k][:, 0] for k in POSE_KEYS), batch["gaze_pos"], speech,
            style[:, None].expand(-1, T, -1), s["anim_input_mean"], s["anim_input_std"],
            s["anim_output_mean"], s["anim_output_std"], dt)
        O = dict(zip(POSE_KEYS, outputs))
        W = {k: batch[k] for k in POSE_KEYS}
        return compute_loss(O, W, batch["gaze_pos"], parents, dt, mu, logvar, iteration)

    return loss_fn


def gather_batch(arrays, window, window_starts, ex_idx, ex_lengths):
    """The training batch from the corpus tracks ({key: (N, ...) tensor})
    and one step's index arrays, as the port's device gather."""
    dev = arrays["audio_features"].device

    def idx(a):
        return torch.as_tensor(np.asarray(a), device=dev).long()

    gather = idx(window_starts)[:, None] + torch.arange(window, device=dev)[None, :]
    batch = {k: arrays[k][gather] for k in WINDOW_KEYS}
    ex_idx, ex_lengths = idx(ex_idx), idx(ex_lengths)
    B, Lmax = ex_idx.shape
    parts = [arrays[k][ex_idx].reshape(B, Lmax, -1) for k in EXAMPLE_KEYS]
    parts.append(torch.zeros((B, Lmax, 3), device=dev))
    ex = torch.cat(parts, dim=-1)
    mask = torch.arange(Lmax, device=dev)[None, :] < ex_lengths[:, None]
    batch["example"] = ex * mask[..., None]
    batch["example_lengths"] = ex_lengths.to(torch.int32)
    return batch


def make_optimizer(cfg, nets):
    t = cfg["train_opt"]
    schedule = exponential_step_schedule(t["learning_rate"], t["learning_rate_decay"], every=1000)
    return RAdam(named_parameters(nets), schedule, eps=t["eps"])


def train_steps(cfg, nets, stats, parents, dt, batches, generator):
    """Eager training steps of ``nets`` over ``batches`` (one dict of
    gathered tensors a step) -> (each step's total loss, the first step's
    gradients {name: tensor}). The parameters are updated in place."""
    optimizer = make_optimizer(cfg, nets)
    loss_fn = make_loss_fn(cfg, stats, parents, dt)
    params = list(optimizer.params.values())
    losses, first = [], None
    for iteration, batch in enumerate(batches):
        for p in params:
            p.grad = None
        loss, _ = loss_fn(nets, batch, iteration, generator)
        loss.backward()
        if first is None:
            first = {k: p.grad.detach().clone() for k, p in optimizer.params.items()}
        optimizer.step()
        losses.append(float(loss.detach()))
    return losses, first


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def style_encoding(cfg, nets, stats, style_anim, frames, temperature, seed, device):
    """A request's style: the one-hot label (``style_anim`` an int), or the
    example clip's frames [a, b) featurized and encoded at its own length,
    the VAE draw from a generator on ``device`` seeded with ``seed`` ->
    ((1, C) tensor, the clip's features)."""
    if isinstance(style_anim, int):
        one_hot = torch.zeros((1, len(cfg["dataset"]["styles"])), device=device)
        one_hot[0, style_anim] = 1.0
        return one_hot, None
    anim = dict(style_anim)
    if frames is not None:
        anim["rotations"] = anim["rotations"][frames[0] : frames[1]]
        anim["positions"] = anim["positions"][frames[0] : frames[1]]
    feats = features.preprocess_animation(anim, device=device)
    vec = example_feature_vec(feats.root_vel, feats.root_vrt, feats.lpos, feats.ltxy,
                              feats.lvel, feats.lvrt)
    x = (vec - stats["anim_input_mean"]) / stats["anim_input_std"]
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    emb, _, _ = nets["style_encoder"](x[None], temperature=temperature, generator=generator)
    return emb, feats


@torch.no_grad()
def infer(cfg, nets, stats, dt, audio, first_pose, style, frames=None, temperature=1.0,
          seed=1234, normalize=None, device="cpu"):
    """One request through the reference: ``audio`` (numpy samples at the
    configuration's rate), ``first_pose`` (a BVH dict, or None to take the
    style clip's first frame), ``style`` (a label index or a BVH dict with
    its ``frames``) -> ({root_pos, root_rot, lpos, ltxy, lrot} (T, ...)
    float32 tensors: the rollout's frames, joint rotations as quaternions
    in ``lrot``)."""
    ac = cfg["audio_conf"]
    n_frames = int(round(60.0 * (len(audio) / ac["sampling_rate"])))
    feats_audio = features.audio_features(audio, 60, n_frames, ac, normalize, device)
    s = stats
    speech = nets["speech_encoder"]((feats_audio[None] - s["audio_input_mean"])
                                    / s["audio_input_std"])
    emb, style_feats = style_encoding(cfg, nets, s, style, frames, temperature, seed, device)
    feats0 = (features.preprocess_animation(first_pose, device=device) if first_pose is not None
              else style_feats)
    state0 = tuple(getattr(feats0, k)[0:1] for k in POSE_KEYS)
    gaze = feats0.gaze_pos[0].expand(n_frames, 3)[None]
    out = decoder.rollout(nets["decoder"], *state0, gaze, speech,
                          emb[:, None].expand(-1, n_frames, -1).contiguous(),
                          s["anim_input_mean"], s["anim_input_std"], s["anim_output_mean"],
                          s["anim_output_std"], dt)
    root_pos, root_rot, lpos, ltxy = (out[i][0] for i in (0, 1, 4, 5))
    lrot = quat.from_xform(xform.orthogonalize_from_xy(ltxy))
    return {"root_pos": root_pos, "root_rot": root_rot, "lpos": lpos, "ltxy": ltxy,
            "lrot": lrot}


def bvh_pose(frames):
    """What a BVH written from ``frames`` holds, re-anchored at the origin
    with an identity start rotation and the root baked into joint 0 (the
    port's `write_bvh`, float32 on the host) -> (root position (T, 3),
    joint rotations as matrices (T, J, 3, 3))."""
    root_pos, root_rot = frames["root_pos"].float().cpu(), frames["root_rot"].float().cpu()
    lpos, lrot = frames["lpos"].float().cpu().clone(), frames["lrot"].float().cpu().clone()
    offset_pos, offset_rot = root_pos[0:1].clone(), root_rot[0:1].clone()
    root_pos = quat.mul_vec(quat.inv(offset_rot), root_pos - offset_pos)
    root_rot = quat.mul(quat.inv(offset_rot), root_rot)
    lpos0 = quat.mul_vec(root_rot, lpos[:, 0]) + root_pos
    lrot[:, 0] = quat.mul(root_rot, lrot[:, 0])
    return lpos0, quat.to_xform(lrot)


def parsed_bvh_pose(anim, names):
    """(root position (T, 3), joint rotations as matrices (T, J, 3, 3)) of a
    parsed BVH dict (`bvh.load`), the joints in the order of ``names``."""
    order = [list(anim["names"]).index(n) for n in names]
    rot = torch.as_tensor(np.asarray(anim["rotations"], np.float32)[:, order])
    q = quat.from_euler(torch.deg2rad(rot), anim["order"])
    return torch.as_tensor(np.asarray(anim["positions"][:, 0], np.float32)), quat.to_xform(q)
