"""Weight bridge: the JAX package's parameter pytrees -> PyTorch state dicts.

`zeggs_tpu` stores a linear weight as (in, out), a conv weight as
(K, in, out), the attention in-projection as (E, 3E) and GRU weights as
(in, 3H) with gates r, z, n. The port holds PyTorch's (out, in) and
(out, in, K) layouts under PyTorch's parameter names. The conversion is a
transpose and a rename, never arithmetic, so every value is carried over
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from . import checkpoint

# leaf name in the JAX pytree -> (PyTorch name, transposes the axes)
_LEAVES = {
    "w": ("weight", True),
    "b": ("bias", False),
    "scale": ("weight", False),
    "bias": ("bias", False),
    "w_ih": ("weight_ih", True),
    "w_hh": ("weight_hh", True),
    "b_ih": ("bias_ih", False),
    "b_hh": ("bias_hh", False),
    "in_proj_w": ("in_proj_weight", True),
    "in_proj_b": ("in_proj_bias", False),
}


def load_jax_npz(path):
    """Read a native .npz network written by `zeggs_tpu.io.checkpoint.save`
    -> nested dict of numpy arrays."""
    params, _ = checkpoint.load(path)
    return params


def _torch_layout(arr, transpose):
    arr = np.asarray(arr)
    if transpose:
        # (in, out) -> (out, in); conv (K, in, out) -> (out, in, K)
        arr = arr.T
    return torch.from_numpy(np.array(arr, order="C"))  # a writable copy


def from_jax(params_np, prefix=""):
    """Nested JAX parameter dict (numpy leaves) -> flat PyTorch state dict."""
    out = {}
    for key, value in params_np.items():
        if isinstance(value, dict):
            out.update(from_jax(value, f"{prefix}{key}."))
            continue
        if key not in _LEAVES:
            raise KeyError(f"unknown parameter leaf {prefix}{key}")
        name, transpose = _LEAVES[key]
        out[f"{prefix}{name}"] = _torch_layout(value, transpose)
    return out


def to_jax(module: nn.Module):
    """The inverse of `from_jax`: a port module -> the JAX package's nested
    parameter dict of numpy arrays, ready for `checkpoint.save`."""
    to_leaf = {name: (leaf, transpose) for leaf, (name, transpose) in _LEAVES.items()
               if leaf not in ("scale", "bias")}
    tree = {}
    for path, m in module.named_modules():
        node = tree
        for part in filter(None, path.split(".")):
            node = node.setdefault(part, {})
        for name, p in m.named_parameters(recurse=False):
            if isinstance(m, nn.LayerNorm):
                leaf, transpose = {"weight": "scale", "bias": "bias"}[name], False
            else:
                leaf, transpose = to_leaf[name]
            arr = p.detach().cpu().numpy()
            node[leaf] = np.ascontiguousarray(arr.T if transpose else arr)
    return tree
