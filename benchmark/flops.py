"""The yardstick: the card's peaks and the operations and bytes a layer
needs, computed from the configuration's widths alone.

Peaks are an NVIDIA H100 SXM's data-sheet rates (dense, at its 700 W limit),
copied from `zeggs_tpu_torch/device.py`; float32 runs outside the tensor
cores (TF32 off). A product of (M, K) and (K, N) is 2 M K N operations; the
backward of a product computes the gradient of each operand that needs one
(2 M K N each), as `torch.utils.flop_counter.FlopCounterMode` counts them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def bound_s(nbytes, ops, kind="float32"):
    """The least seconds an H100 needs to move ``nbytes`` (each input read
    once, each output written once) and do ``ops`` operations of ``kind``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[kind])


def gru_cell_bound_s(B, in_dim, H):
    """One step of the GRU-cell kernel at batch B (`chip_smoke.py`'s
    arithmetic): the two weight matrices, four bias vectors, the input and
    the hidden state read, the new state written; 2 B 3H (in + H)
    operations."""
    nbytes = 4 * (3 * H * in_dim + 3 * H * H + 4 * H + B * in_dim + 2 * B * H)
    return bound_s(nbytes, 2 * B * 3 * H * (in_dim + H))


def _widths(cfg):
    net, ds = cfg["net_opt"], cfg["dataset"]
    label = cfg["train_opt"]["style_encoding_type"] == "label"
    return dict(
        A=ds["audio_features"], P=ds["pose_input_size"], O=ds["pose_output_size"],
        Sh=net["speech_encoder"]["nhidden"], S=net["speech_encoder"]["speech_encoding_size"],
        C=len(ds["styles"]) if label else net["style_encoder"]["style_encoding_size"],
        H=net["decoder"]["nhidden"], label=label,
        Eh=net["style_encoder"]["nhidden"], E=2 * net["style_encoder"]["style_encoding_size"]
        if net["style_encoder"]["use_vae"] else net["style_encoder"]["style_encoding_size"])


def speech_encoder_flops(cfg, frames):
    """Forward products of the speech encoder over ``frames`` frames: conv
    k=1, conv k=31, linear."""
    w = _widths(cfg)
    return 2 * frames * (w["A"] * w["Sh"] + 31 * w["Sh"] * w["S"] + w["S"] * w["S"])


def decoder_step_flops(cfg):
    """Forward products of one decoder step, the speech/style part of the
    input products included: layer0 and GRU0 over [pose | speech | style]
    (and GRU0's hidden input), GRU0's and GRU1's hidden products, GRU1's
    input product, the output layer."""
    w = _widths(cfg)
    P, S, C, H, O = w["P"], w["S"], w["C"], w["H"], w["O"]
    return 2 * ((P + S + C) * H + (H + P + S + C) * 3 * H + H * 3 * H + 2 * H * 3 * H + H * O)


def rollout_flops_per_frame(cfg):
    """Forward products a generated frame needs: the speech encoder's and a
    decoder step's."""
    return speech_encoder_flops(cfg, 1) + decoder_step_flops(cfg)


def train_step_flops(cfg, B=None, T=None, L=None):
    """Products of one training step, forward and backward: B windows of T
    frames with examples L frames wide (the dataset's longest), the style
    encoder ``attn`` (v1) or a label (v2). A gradient is counted where an
    operand needs one: the audio features, the examples and a label need
    none, and neither does the pose input of the first decoder step."""
    t, w = cfg["train_opt"], _widths(cfg)
    B = t["batchsize"] if B is None else B
    T = t["window"] if T is None else T
    L = 2 * cfg["net_opt"]["style_encoder"]["example_length"] if L is None else L
    A, P, O, Sh, S, C, H = (w[k] for k in ("A", "P", "O", "Sh", "S", "C", "H"))

    def prod(m, k, n, grads=2):
        # forward, then one product a gradient (input, weight)
        return 2 * m * k * n * (1 + grads)

    f = 0
    # speech encoder over B x T frames; conv0 reads the features
    f += prod(B * T, A, Sh, 1) + prod(B * T, 31 * Sh, S) + prod(B * T, S, S)
    if not w["label"]:
        Eh, E = w["Eh"], w["E"]
        n, nh = B * L, 4
        f += prod(n, 3 * P, Eh, 1) + prod(n, 3 * Eh, E)  # convs (examples need no grad)
        f += prod(n, E, 3 * E) + prod(n, E, E)  # in and out projections
        f += 2 * prod(B * nh * L, E // nh, L)  # logits and weighted values
        f += 2 * prod(n, 3 * E, E)  # feed-forward convs
    # cell-state encoder: [pose0 | style] -> H -> H -> 2H
    # (a label needs no gradient, and then neither does its first input)
    f += prod(B, P + C, H, 1 if w["label"] else 2) + prod(B, H, H) + prod(B, H, 2 * H)
    steps = T - 1
    # the hoisted speech/style part of layer0's and GRU0's input products
    f += prod(B * steps, S + C, H) + prod(B * steps, S + C, 3 * H)
    # per step: pose -> layer0, hidden -> GRU0, pose -> GRU0, GRU0 hh, GRU1 ih and hh, out
    per_step = (prod(B, P, H) + prod(B, H, 3 * H) + prod(B, P, 3 * H) + prod(B, H, 3 * H)
                + 2 * prod(B, H, 3 * H) + prod(B, H, O))
    first_step_pose = prod(B, P, H) + prod(B, P, 3 * H) - prod(B, P, H, 1) - prod(B, P, 3 * H, 1)
    f += steps * per_step - first_step_pose
    return f
