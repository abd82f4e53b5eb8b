"""A one-axis device mesh for batched generation (counterpart of
`zeggs_tpu/parallel/mesh.py`).

`zeggs_tpu` lays a ('data',) mesh over its devices and shards a batch's
leading axis over it. Here a mesh is an ordered tuple of torch devices:
`shard_rows` cuts a batch into one contiguous block of rows a device, as
``PartitionSpec('data')`` lays them out, and `infer/batch.py` runs each
block on its device from a host thread of its own. `generate_batch` pads
a chunk's rows to a multiple of the mesh's size, as `zeggs_tpu` does, so
its blocks are equal; `shard_rows` itself takes any batch (near-equal
blocks, `torch.tensor_split`).

A mesh may name one device more than once: each entry is then its own
replica, with its own thread and stream, over the same weights.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import require_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices, one replica each."""

    devices: tuple

    @property
    def size(self):
        return len(self.devices)


def _resolve(name):
    """``name`` through `require_device`, a card named by its index."""
    device = require_device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _cards():
    require_device("cuda")  # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(n_devices=None, devices=None):
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    card this process sees). Every entry goes through `require_device`, so
    a card the process cannot see raises; the mesh never moves to the CPU
    on its own."""
    devices = _cards() if devices is None else list(devices)
    n = len(devices) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"a mesh of {n} devices from {len(devices)} given")
    return Mesh(tuple(_resolve(d) for d in devices[:n]))


def create_mesh_for_batch(batch_size, devices=None):
    """A mesh over the most of ``devices`` (default: every card) that
    divide ``batch_size``: a small batch still runs on a large machine."""
    devices = _cards() if devices is None else list(devices)
    n = len(devices)
    while n > 1 and batch_size % n:
        n -= 1
    return create_mesh(n, devices)


def shard_rows(x, mesh):
    """``x``'s leading axis in ``mesh.size`` contiguous blocks, in the
    mesh's order (views; sizes differ by at most one, the larger first; a
    block is empty where the mesh has more devices than rows)."""
    return list(torch.tensor_split(x, mesh.size))
