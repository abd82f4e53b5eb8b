"""The reference's whole-module `.pt` checkpoints (counterpart of
`zeggs_tpu/io/torch_compat.py`).

The reference saves pickled `nn.Module` objects, whose classes live in its
`modules.py`. `load_reference_module` unpickles them against shim classes
registered as the module ``modules`` (unpickling restores each module's
attribute dict; no reference code runs) and returns the state dict;
`load_reference_networks` turns a models directory into the JAX package's
numpy parameter trees, the same trees `zeggs_tpu.io.torch_compat` makes,
which `io/weights.py::from_jax` then loads into the port's modules.

One table a network (`_LAYOUT`) maps each leaf group of the JAX tree to its
reference state-dict prefix. It drives both directions: `convert_*` reads a
reference state dict, and `reference_module` builds a reference-layout
module from a JAX tree (the inverse, for writing `.pt` files that the
reference and both packages read).
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

_SHIM_CLASSES = (
    "Decoder", "RecurrentDecoderNormal", "RecurrentDecoderFiLM", "CellStateEncoder",
    "SpeechEncoder", "StyleEncoder", "StyleEncoderGRU", "StyleEncoderAttn", "LinearNorm",
    "PositionalEncoding", "FFTBlock", "MultiHeadAttention", "PositionWiseConvFF", "ConvNorm1D",
    "AvgPoolNorm1D",
)


def _make_shim():
    """A ``modules`` namespace of plain `nn.Module` subclasses named as the
    reference's classes: interchangeable with `zeggs_tpu`'s shim, so either
    package unpickles under the other's."""
    shim = types.ModuleType("modules")
    shim.__zeggs_shim__ = True
    for name in _SHIM_CLASSES:
        setattr(shim, name, type(name, (nn.Module,), {"__module__": "modules"}))
    return shim


_SHIM = _make_shim()


def _install_modules_shim():
    """Make ``modules`` importable for unpickling. A module already under
    that name (the JAX package's shim, or the reference's own modules.py)
    is kept: either can unpickle the reference's checkpoints."""
    if "modules" not in sys.modules:
        sys.modules["modules"] = _SHIM
    return sys.modules["modules"]


# -- layout -----------------------------------------------------------------

# (JAX tree path, reference state-dict prefix, kind); a kind is "linear",
# "conv", "ln", "mha" or ("gru", layer, suffix)
_LAYOUT = {
    "speech_encoder": [
        ("conv0", "layer0", "conv"), ("conv1", "layer1", "conv"), ("linear", "layer2", "linear"),
    ],
    "style_encoder_attn": [
        ("body.conv0", "encoder.convs.0.conv", "conv"),
        ("body.ln0", "encoder.convs.2", "ln"),
        ("body.conv1", "encoder.convs.4.conv", "conv"),
        ("body.ln1", "encoder.convs.6", "ln"),
        ("body.mha", "encoder.blocks.0.attention.multi_head_attention", "mha"),
        ("body.mha_ln", "encoder.blocks.0.attention.layer_norm", "ln"),
        ("body.ff_conv0", "encoder.blocks.0.feed_forward.convs.0.conv", "conv"),
        ("body.ff_conv1", "encoder.blocks.0.feed_forward.convs.2.conv", "conv"),
        ("body.ff_ln", "encoder.blocks.0.feed_forward.layer_norm", "ln"),
    ],
    "style_encoder_gru": [
        ("body.conv0", "encoder.convs.0.conv", "conv"),
        ("body.conv1", "encoder.convs.2.conv", "conv"),
        ("body.gru_fwd", "encoder.rnn_layer", ("gru", 0, "")),
        ("body.gru_bwd", "encoder.rnn_layer", ("gru", 0, "_reverse")),
        ("body.proj", "encoder.projection_layer.linear_layer", "linear"),
    ],
    "decoder_normal": [
        ("cell_state_encoder.l0", "cell_state_encoder.layer0", "linear"),
        ("cell_state_encoder.l1", "cell_state_encoder.layer1", "linear"),
        ("cell_state_encoder.l2", "cell_state_encoder.layer2", "linear"),
        ("cell.layer0", "recurrent_decoder.layer0", "linear"),
        ("cell.gru0", "recurrent_decoder.layer1", ("gru", 0, "")),
        ("cell.gru1", "recurrent_decoder.layer1", ("gru", 1, "")),
        ("cell.out", "recurrent_decoder.layer2", "linear"),
    ],
    "decoder_film": [
        ("cell_state_encoder.l0", "cell_state_encoder.layer0", "linear"),
        ("cell_state_encoder.l1", "cell_state_encoder.layer1", "linear"),
        ("cell_state_encoder.l2", "cell_state_encoder.layer2", "linear"),
        ("cell.gammas", "recurrent_decoder.gammas_predictor.linear_layer", "linear"),
        ("cell.betas", "recurrent_decoder.betas_predictor.linear_layer", "linear"),
        ("cell.layer0", "recurrent_decoder.layer0", "linear"),
        ("cell.gru0", "recurrent_decoder.layer1", ("gru", 0, "")),
        ("cell.gru1", "recurrent_decoder.layer1", ("gru", 1, "")),
        ("cell.layer2", "recurrent_decoder.layer2", "linear"),
        ("cell.out", "recurrent_decoder.layer3", "linear"),
    ],
}

# JAX leaf -> (reference name under the prefix, transposed); a GRU's names
# take the layer and direction suffix
_LEAVES = {
    "linear": {"w": ("weight", True), "b": ("bias", False)},
    "conv": {"w": ("weight", True), "b": ("bias", False)},
    "ln": {"scale": ("weight", False), "bias": ("bias", False)},
    "gru": {"w_ih": ("weight_ih", True), "w_hh": ("weight_hh", True),
            "b_ih": ("bias_ih", False), "b_hh": ("bias_hh", False)},
}


def _leaf_names(kind):
    """[(JAX leaf path, reference name, transposed)] of one leaf group."""
    if kind == "mha":
        return [("in_proj_w", "in_proj_weight", True), ("in_proj_b", "in_proj_bias", False),
                ("out_proj.w", "out_proj.weight", True), ("out_proj.b", "out_proj.bias", False)]
    if isinstance(kind, tuple):
        _, layer, suffix = kind
        return [(k, f"{n}_l{layer}{suffix}", t) for k, (n, t) in _LEAVES["gru"].items()]
    return [(k, n, t) for k, (n, t) in _LEAVES[kind].items()]


def _t(x):
    """A state-dict tensor -> numpy float32."""
    return np.asarray(x.detach().cpu().numpy(), dtype=np.float32)


def _convert(sd, layout):
    """Reference state dict -> nested JAX tree (transposes are numpy's
    reversed-axes views, as `zeggs_tpu` makes them)."""
    tree = {}
    for path, prefix, kind in _LAYOUT[layout]:
        for leaf, name, transpose in _leaf_names(kind):
            node = tree
            *parents, last = f"{path}.{leaf}".split(".")
            for p in parents:
                node = node.setdefault(p, {})
            arr = _t(sd[f"{prefix}.{name}"])
            node[last] = arr.T if transpose else arr
    return tree


def convert_speech_encoder(sd):
    return _convert(sd, "speech_encoder")


def convert_style_encoder(sd, encoder_type="attn"):
    return _convert(sd, f"style_encoder_{encoder_type}")


def convert_decoder(sd, rnn_cond="normal"):
    return _convert(sd, f"decoder_{'normal' if rnn_cond == 'normal' else 'film'}")


# -- reading ------------------------------------------------------------------

def load_reference_module(path):
    """`torch.load` a reference whole-module `.pt` -> its state dict. Only
    for files of a trusted source: unpickling can run code."""
    _install_modules_shim()
    # the default weights_only=True (PyTorch >= 2.6) cannot restore modules
    module = torch.load(path, map_location="cpu", weights_only=False)
    return module.state_dict()


def load_reference_networks(models_dir, style_encoding_type="example", rnn_cond="normal"):
    """The speech_encoder / decoder / style_encoder `.pt` files of a
    reference models directory that exist -> {name: JAX parameter tree}. The
    style body is "attn" when the state dict has attention blocks, else
    "gru"."""
    models_dir = Path(models_dir)
    out = {}
    if (models_dir / "speech_encoder.pt").exists():
        out["speech_encoder"] = convert_speech_encoder(
            load_reference_module(models_dir / "speech_encoder.pt"))
    if (models_dir / "decoder.pt").exists():
        out["decoder"] = convert_decoder(load_reference_module(models_dir / "decoder.pt"), rnn_cond)
    if style_encoding_type == "example" and (models_dir / "style_encoder.pt").exists():
        sd = load_reference_module(models_dir / "style_encoder.pt")
        out["style_encoder"] = convert_style_encoder(
            sd, "attn" if any("blocks" in k for k in sd) else "gru")
    return out


# -- writing ------------------------------------------------------------------

def _layout_of(name, tree):
    if name == "style_encoder":
        return "style_encoder_attn" if "mha" in tree["body"] else "style_encoder_gru"
    if name == "decoder":
        return "decoder_film" if "gammas" in tree["cell"] else "decoder_normal"
    return name


def _reference_state_dict(tree, layout):
    """The inverse of `_convert`: JAX tree -> reference state dict."""
    sd = {}
    for path, prefix, kind in _LAYOUT[layout]:
        for leaf, name, transpose in _leaf_names(kind):
            node = tree
            for p in f"{path}.{leaf}".split("."):
                node = node[p]
            arr = np.asarray(node, np.float32)
            sd[f"{prefix}.{name}"] = torch.from_numpy(np.array(arr.T if transpose else arr,
                                                               order="C"))
    return sd


def _conv_norm(w):
    m = _SHIM.ConvNorm1D()
    m.conv = nn.Conv1d(w.shape[1], w.shape[0], w.shape[2])
    return m


def _linear_norm(w):
    m = _SHIM.LinearNorm()
    m.linear_layer = nn.Linear(w.shape[1], w.shape[0])
    return m


def _linear(w):
    return nn.Linear(w.shape[1], w.shape[0])


def _build(layout, sd):
    """An empty module tree of the reference's classes and attribute names
    with the widths of ``sd``."""
    if layout == "speech_encoder":
        m = _SHIM.SpeechEncoder()
        w0, w1 = sd["layer0.weight"], sd["layer1.weight"]
        m.layer0 = nn.Conv1d(w0.shape[1], w0.shape[0], w0.shape[2], padding="same",
                             padding_mode="replicate")
        m.layer1 = nn.Conv1d(w1.shape[1], w1.shape[0], w1.shape[2], padding="same",
                             padding_mode="replicate")
        m.layer2 = _linear(sd["layer2.weight"])
        return m
    if layout.startswith("style_encoder"):
        m, e = _SHIM.StyleEncoder(), None
        c0 = sd["encoder.convs.0.conv.weight"]
        if layout == "style_encoder_attn":
            e = _SHIM.StyleEncoderAttn()
            c1 = sd["encoder.convs.4.conv.weight"]
            e.convs = nn.Sequential(_conv_norm(c0), nn.ReLU(), nn.LayerNorm(c0.shape[0]),
                                    nn.Dropout(0.2), _conv_norm(c1), nn.ReLU(),
                                    nn.LayerNorm(c1.shape[0]), nn.Dropout(0.2))
            E = c1.shape[0]
            ff = "encoder.blocks.0.feed_forward.convs"
            block = _SHIM.FFTBlock()
            block.attention = _SHIM.MultiHeadAttention()
            block.attention.multi_head_attention = nn.MultiheadAttention(E, 4, dropout=0.1)
            block.attention.layer_norm = nn.LayerNorm(E)
            block.feed_forward = _SHIM.PositionWiseConvFF()
            block.feed_forward.convs = nn.Sequential(
                _conv_norm(sd[f"{ff}.0.conv.weight"]), nn.ReLU(),
                _conv_norm(sd[f"{ff}.2.conv.weight"]))
            block.feed_forward.layer_norm = nn.LayerNorm(E)
            e.blocks = nn.ModuleList([block])
        else:
            e = _SHIM.StyleEncoderGRU()
            e.convs = nn.Sequential(_conv_norm(c0), nn.ReLU(),
                                    _conv_norm(sd["encoder.convs.2.conv.weight"]), nn.ReLU())
            H = sd["encoder.rnn_layer.weight_hh_l0"].shape[1]
            e.rnn_layer = nn.GRU(sd["encoder.rnn_layer.weight_ih_l0"].shape[1], H,
                                 batch_first=True, bidirectional=True)
            e.projection_layer = _linear_norm(sd["encoder.projection_layer.linear_layer.weight"])
        m.encoder = e
        return m
    m = _SHIM.Decoder()
    m.cell_state_encoder = _SHIM.CellStateEncoder()
    for i in range(3):
        setattr(m.cell_state_encoder, f"layer{i}",
                _linear(sd[f"cell_state_encoder.layer{i}.weight"]))
    rd = "recurrent_decoder"
    film = layout == "decoder_film"
    r = _SHIM.RecurrentDecoderFiLM() if film else _SHIM.RecurrentDecoderNormal()
    if film:
        r.gammas_predictor = _linear_norm(sd[f"{rd}.gammas_predictor.linear_layer.weight"])
        r.betas_predictor = _linear_norm(sd[f"{rd}.betas_predictor.linear_layer.weight"])
    r.layer0 = _linear(sd[f"{rd}.layer0.weight"])
    H = sd[f"{rd}.layer1.weight_hh_l0"].shape[1]
    r.layer1 = nn.GRU(sd[f"{rd}.layer1.weight_ih_l0"].shape[1], H, num_layers=2, batch_first=True)
    r.layer2 = _linear(sd[f"{rd}.layer2.weight"])
    if film:
        r.layer3 = _linear(sd[f"{rd}.layer3.weight"])
    m.recurrent_decoder = r
    return m


def reference_module(name, tree):
    """A module of the reference's classes and layout holding the JAX tree
    ``tree`` of network ``name`` ("speech_encoder", "style_encoder" or
    "decoder"); the body and cell kinds follow the tree."""
    layout = _layout_of(name, tree)
    sd = _reference_state_dict(tree, layout)
    module = _build(layout, sd)
    module.load_state_dict(sd, strict=True)
    return module.eval()


def save_reference_networks(models_dir, trees):
    """Write {name: JAX tree} as the reference's whole-module pickles,
    ``<models_dir>/<name>.pt``. The classes are pickled under the module
    name ``modules``, as the reference's are."""
    models_dir = Path(models_dir)
    models_dir.mkdir(parents=True, exist_ok=True)
    previous = sys.modules.get("modules")
    # pickle looks each class up under its module's name: the shim's own
    sys.modules["modules"] = _SHIM
    try:
        for name, tree in trees.items():
            torch.save(reference_module(name, tree), models_dir / f"{name}.pt")
    finally:
        if previous is None:
            del sys.modules["modules"]
        else:
            sys.modules["modules"] = previous
