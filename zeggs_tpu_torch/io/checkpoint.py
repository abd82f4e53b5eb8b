"""Native `.npz` checkpoints (the port's own copy of the numpy half of
`zeggs_tpu/io/checkpoint.py`): a parameter tree flattened to "/"-joined
keys in one `.npz`, plus an optional JSON meta blob. Both packages read and
write the same files."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_SEP = "/"
_META_KEY = "__meta__"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix[: -len(_SEP)]] = np.asarray(tree)
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def fix_lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [fix_lists(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix_lists(v) for k, v in node.items()}

    return fix_lists(tree)


def save(path, tree, meta=None):
    """Save a parameter tree (+ JSON-able meta) to one .npz file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    if meta is not None:
        flat[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load(path):
    """Load a .npz checkpoint -> (tree, meta)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = None
    if _META_KEY in flat:
        meta = json.loads(bytes(flat.pop(_META_KEY).tobytes()).decode())
    return _unflatten(flat), meta
