"""The ``film`` decoder of ZEGGS in plain PyTorch, and the reference's
inference with it.

ZeroEGGS's `RecurrentDecoderFiLM` (`ZEGGS/modules.py:188-227` of
https://github.com/ubisoft/ubisoft-laforge-ZeroEGGS), selected by
``net_opt.decoder.rnn_cond: "film"``; FiLM is feature-wise linear
modulation (Perez et al., arXiv:1709.07871). The parameters carry the
names and the order of the port's `FilmCell`. A cell-state encoder sets the
two GRU layers' hidden state from (frame-0 pose, style); then, per frame t,
at hidden size H:

    ps    = [pose_t | speech_t]
    gamma = style_t Wg^T + bg + 1,  beta = style_t Wb^T + bb    (2H each)
    x0    = ELU(ps W0^T + b0) * gamma[:H] + beta[:H]
    h0    = GRU0([x0 | ps], h0)
    h1    = GRU1(h0, h1)
    x2    = ELU(h1 W2^T + b2) * gamma[H:] + beta[H:]
    y     = x2 Wo^T + bo,  then devectorize_output -> the next pose.

One departure in the order of the sums, none in the equations: the speech
part of layer0's and of GRU0's input product (with layer0's bias and GRU0's
input bias), and gamma and beta, are computed once over all frames, as the
port hoists them and as `decoder.py` hoists the ``normal`` cell's.

`build_networks` and `infer` are `model.py`'s, with this decoder; `load`,
`bvh_pose` and `parsed_bvh_pose` are `model.py`'s own, so that this module
stands where `model.py` stands for a FiLM configuration. No kernel, no CUDA
graph, no batching across requests.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import features, quat, xform
from . import layers as L
from . import pose as P
from .decoder import CellStateEncoder
from .model import POSE_KEYS, bvh_pose, label_style, load, parsed_bvh_pose, style_encoding
from .speech_encoder import SpeechEncoder
from .style_encoder import StyleEncoder

__all__ = ["Decoder", "rollout", "build_networks", "infer", "load", "bvh_pose",
           "parsed_bvh_pose"]


class FilmCell(nn.Module):
    def __init__(self, pose_input_size, speech_encoding_size, style_encoding_size, hidden_size,
                 pose_output_size, device=None):
        super().__init__()
        ps_input = pose_input_size + speech_encoding_size
        self.gammas = nn.Linear(style_encoding_size, 2 * hidden_size, device=device)
        self.betas = nn.Linear(style_encoding_size, 2 * hidden_size, device=device)
        self.layer0 = nn.Linear(ps_input, hidden_size, device=device)
        self.gru0 = nn.GRUCell(ps_input + hidden_size, hidden_size, device=device)
        self.gru1 = nn.GRUCell(hidden_size, hidden_size, device=device)
        self.layer2 = nn.Linear(hidden_size, hidden_size, device=device)
        self.out = nn.Linear(hidden_size, pose_output_size, device=device)


class Decoder(nn.Module):
    def __init__(self, pose_input_size, pose_output_size, speech_encoding_size,
                 style_encoding_size, hidden_size, num_rnn_layers=2, device=None):
        super().__init__()
        self.num_rnn_layers = num_rnn_layers
        self.cell_state_encoder = CellStateEncoder(
            pose_input_size + style_encoding_size, hidden_size, num_rnn_layers, device=device)
        self.cell = FilmCell(pose_input_size, speech_encoding_size, style_encoding_size,
                             hidden_size, pose_output_size, device=device)


def rollout(dec: Decoder, root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
            gaze_pos, speech_encoding, style_encoding, anim_input_mean, anim_input_std,
            anim_output_mean, anim_output_std, dt):
    """Autoregressive rollout from the frame-0 state (B, ...) under per-frame
    conditioning gaze_pos (B, T, 3), speech (B, T, S), style (B, T, C) ->
    the 8 trajectories (B, T, ...), frame 0 equal to the inputs."""
    cse, cp = dec.cell_state_encoder, dec.cell
    pose0 = P.vectorize_input(root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt,
                              gaze_pos[:, 0], anim_input_mean, anim_input_std)
    h = L.elu(L.linear(torch.cat([pose0, style_encoding[:, 0]], dim=-1), cse.l0))
    h = L.elu(L.linear(h, cse.l1))
    h = L.linear(h, cse.l2).reshape(pose0.shape[0], dec.num_rnn_layers, -1).transpose(0, 1)
    h0, h1 = h[0], h[1].contiguous()

    pose_dim = anim_input_mean.shape[-1]
    H = cp.gru1.weight_hh.shape[1]
    njoints = lpos.shape[1]
    w0, wg = cp.layer0.weight, cp.gru0.weight_ih
    w0_pose, wg_h, wg_pose = w0[:, :pose_dim], wg[:, :H], wg[:, H : H + pose_dim]
    speech, style = speech_encoding[:, 1:], style_encoding[:, 1:]
    pre_l0 = F.linear(speech, w0[:, pose_dim:], cp.layer0.bias)
    pre_g0 = F.linear(speech, wg[:, H + pose_dim :], cp.gru0.bias_ih)
    gammas = L.linear(style, cp.gammas) + 1.0
    betas = L.linear(style, cp.betas)

    state = (root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt)
    frames = [state]
    for t in range(speech_encoding.shape[1] - 1):
        pose = P.vectorize_input(*state, gaze_pos[:, t + 1], anim_input_mean, anim_input_std)
        x0 = L.elu(pre_l0[:, t] + pose @ w0_pose.T) * gammas[:, t, :H] + betas[:, t, :H]
        gi = pre_g0[:, t] + x0 @ wg_h.T + pose @ wg_pose.T
        h0 = L.gru_gates(gi, F.linear(h0, cp.gru0.weight_hh, cp.gru0.bias_hh), h0)
        h1 = L.gru_cell(h0, h1, cp.gru1)
        x2 = L.elu(L.linear(h1, cp.layer2)) * gammas[:, t, H:] + betas[:, t, H:]
        state = P.devectorize_output(L.linear(x2, cp.out), state[0], state[1], njoints, dt,
                                     anim_output_mean, anim_output_std)
        frames.append(state)
    return tuple(torch.stack([f[i] for f in frames], dim=1) for i in range(8))


def build_networks(cfg, device="cpu"):
    """{name: module} of a FiLM configuration on ``device`` (``"meta"`` gives
    the shapes alone), parameters in the port's names and order."""
    net, ds = cfg["net_opt"], cfg["dataset"]
    se, dec, st = net["speech_encoder"], net["decoder"], net["style_encoder"]
    if dec["rnn_cond"] != "film":
        raise ValueError(f"{cfg.get('name')}: rnn_cond {dec['rnn_cond']!r}, not 'film'")
    style = len(ds["styles"]) if label_style(cfg) else st["style_encoding_size"]
    nets = {
        "speech_encoder": SpeechEncoder(ds["audio_features"], se["nhidden"],
                                        se["speech_encoding_size"], device=device),
        "decoder": Decoder(ds["pose_input_size"], ds["pose_output_size"],
                           se["speech_encoding_size"], style, dec["nhidden"],
                           dec["num_rnn_layers"], device=device),
    }
    if not label_style(cfg):
        nets["style_encoder"] = StyleEncoder(ds["pose_input_size"], st["nhidden"],
                                             st["style_encoding_size"], st["use_vae"],
                                             encoder_type=st["type"], device=device)
    return nets


@torch.no_grad()
def infer(cfg, nets, stats, dt, audio, first_pose, style, frames=None, temperature=1.0,
          seed=1234, normalize=None, device="cpu"):
    """`model.infer` with the FiLM rollout: one request -> ({root_pos,
    root_rot, lpos, ltxy, lrot} (T, ...) float32 tensors, joint rotations as
    quaternions in ``lrot``)."""
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
    out = rollout(nets["decoder"], *state0, gaze, speech,
                  emb[:, None].expand(-1, n_frames, -1).contiguous(),
                  s["anim_input_mean"], s["anim_input_std"], s["anim_output_mean"],
                  s["anim_output_std"], dt)
    root_pos, root_rot, lpos, ltxy = (out[i][0] for i in (0, 1, 4, 5))
    lrot = quat.from_xform(xform.orthogonalize_from_xy(ltxy))
    return {"root_pos": root_pos, "root_rot": root_rot, "lpos": lpos, "ltxy": ltxy,
            "lrot": lrot}
