"""One GRU step with PyTorch's equations: the CUDA kernel
(csrc/gru_cell.cu), its weight packing and its plain PyTorch version. Each
launch counts one ``gru_cell.launches`` (`utils.profiling`); the plain
version counts nothing.

Replaces `zeggs_tpu/ops/pallas/gru_kernel.py::fused_gru_cell`:

    r = sigmoid(W_ir x + W_hr h + b_r),  b_r = b_ir + b_hr
    z = sigmoid(W_iz x + W_hz h + b_z),  b_z = b_iz + b_hz
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) n + z h

The r and z biases are folded once, when the cell is packed; b_in and b_hn
stay apart because r multiplies only the hidden part of n. Everything is
float32. The batched decoder rollout runs GRU1 of every inference step
through `fused_gru_cell`.

Inference only: the kernel has no backward, and the folded biases are a
copy that autograd does not see. `pack_gru` and `fused_gru_cell` raise
where autograd would record (grad mode on and an input or parameter that
requires grad) rather than hand back a result without its gradient.

`gru_plan` is how the kernel covers a step: which block owns which hidden
units, which batch tile a launch uses and how often the weights leave L2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn as nn

from ...utils import profiling
from . import build

@dataclasses.dataclass
class PackedGRU:
    """An `nn.GRUCell` in the kernel's layout: PyTorch's own (3H, K)
    weights, K contiguous, gates r, z, n, and the folded biases."""

    weight_ih: torch.Tensor  # (3H, in)
    weight_hh: torch.Tensor  # (3H, H)
    b_rz: torch.Tensor  # (2H,) b_ih + b_hh of the r and z gates
    b_in: torch.Tensor  # (H,)
    b_hn: torch.Tensor  # (H,)

    @property
    def hidden(self):
        return self.weight_hh.shape[1]


def _refuse_autograd(what, tensors):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} is inference only: autograd is recording and the kernel has no "
            "backward; run the differentiable step (models.layers.gru_cell) instead, or "
            "call under torch.no_grad() / torch.inference_mode()"
        )


def pack_gru(cell: nn.GRUCell) -> PackedGRU:
    """Fold the biases of ``cell`` once; the weights are not copied. Raises
    where autograd records on the cell's parameters."""
    _refuse_autograd("pack_gru", list(cell.parameters()))
    H = cell.weight_hh.shape[1]
    b_ih, b_hh = cell.bias_ih, cell.bias_hh
    with torch.no_grad():
        return PackedGRU(
            weight_ih=cell.weight_ih.contiguous(),
            weight_hh=cell.weight_hh.contiguous(),
            b_rz=(b_ih[: 2 * H] + b_hh[: 2 * H]).contiguous(),
            b_in=b_ih[2 * H :].contiguous(),
            b_hn=b_hh[2 * H :].contiguous(),
        )


#: the kernel's constants (csrc/gru_cell.cu): hidden units a block owns,
#: threads, warps, and for each batch tile the columns a ring stage holds
#: and the ring's depth
UNITS, THREADS, WARPS = 8, 256, 8
TILES = {8: (256, 6), 16: (256, 5), 32: (128, 5), 64: (64, 6)}


@dataclasses.dataclass(frozen=True)
class GRUPlan:
    """One launch of the kernel for a (B, in, H) step."""

    tile: int  # batch rows a block holds at once (the kernel's NB)
    passes: int  # batch tiles each block walks: the weights leave L2 this often
    blocks: int  # H / UNITS, each owning UNITS hidden units for every row
    chunk: int  # columns of a ring stage
    stages: int  # ring depth
    chunks: int  # ring stages a pass streams: ceil(in / chunk) + ceil(H / chunk)
    smem_bytes: int

    @property
    def batch_lanes(self):  # BG: lanes of a warp along the batch tile
        return min(self.tile, 16)

    @property
    def column_lanes(self):  # KL: lanes of a warp along a stage's columns
        return 16 // self.batch_lanes

    @property
    def rows_per_thread(self):  # RB
        return self.tile // self.batch_lanes


@functools.lru_cache(maxsize=256)
def gru_plan(B, in_dim, H):
    """The smallest batch tile that holds B rows (else 64, in passes), and
    the rest of the launch as `csrc/gru_cell.cu` runs it."""
    tile = next((t for t in TILES if B <= t), max(TILES))
    chunk, stages = TILES[tile]
    return GRUPlan(tile=tile, passes=max(1, math.ceil(B / tile)), blocks=H // UNITS,
                   chunk=chunk, stages=stages,
                   chunks=math.ceil(in_dim / chunk) + math.ceil(H / chunk),
                   smem_bytes=stages * (3 * UNITS + tile) * (chunk + 4) * 4)


def gru_cell_plain(p: PackedGRU, x, h):
    """The kernel's function in PyTorch: x (B, in), h (B, H) -> (B, H)."""
    H = p.hidden
    gi = x @ p.weight_ih.T
    gh = h @ p.weight_hh.T
    r = torch.sigmoid(gi[:, :H] + gh[:, :H] + p.b_rz[:H])
    z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H] + p.b_rz[H:])
    n = torch.tanh(gi[:, 2 * H :] + p.b_in + r * (gh[:, 2 * H :] + p.b_hn))
    return (1.0 - z) * n + z * h


def _check(p: PackedGRU, x, h):
    H = p.hidden
    B, in_dim = x.shape if x.ndim == 2 else (None, None)
    expected = {
        "weight_ih": (p.weight_ih, (3 * H, in_dim)),
        "weight_hh": (p.weight_hh, (3 * H, H)),
        "b_rz": (p.b_rz, (2 * H,)),
        "b_in": (p.b_in, (H,)),
        "b_hn": (p.b_hn, (H,)),
        "x": (x, (B, in_dim)),
        "h": (h, (B, H)),
    }
    dev = p.weight_hh.device
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the weights on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if in_dim % 8 or H % 8:
        raise ValueError(f"input size {in_dim} and hidden size {H} must be multiples of 8")


@functools.cache
def _library():
    lib = build.load("gru_cell")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.zeggs_gru_cell.argtypes = [p] * 8 + [i] * 4 + [p]
    lib.zeggs_gru_cell.restype = i
    lib.zeggs_gru_cell_error_string.argtypes = [i]
    lib.zeggs_gru_cell_error_string.restype = ctypes.c_char_p
    return lib


def fused_gru_cell(p: PackedGRU, x, h):
    """One GRU step -> (B, H) float32. CUDA tensors launch the kernel; CPU
    tensors take `gru_cell_plain`. Raises on anything the kernel does not
    take, on any CUDA error, and where autograd records."""
    _refuse_autograd("fused_gru_cell", [x, h] + [getattr(p, f.name) for f in dataclasses.fields(p)])
    _check(p, x, h)
    dev = x.device
    if dev.type == "cpu":
        return gru_cell_plain(p, x, h)
    if dev.type != "cuda":
        raise ValueError(f"gru_cell runs on cuda or cpu tensors, not {dev}")
    lib = _library()
    B, in_dim = x.shape
    H = p.hidden
    if any(t.data_ptr() % 16 for t in (x, h, p.weight_ih, p.weight_hh)):
        raise ValueError("x, h and the weights must be 16-byte aligned (16-byte copies)")
    with torch.cuda.device(dev):
        out = torch.empty((B, H), dtype=torch.float32, device=dev)
        err = lib.zeggs_gru_cell(
            x.data_ptr(), h.data_ptr(), p.weight_ih.data_ptr(), p.weight_hh.data_ptr(),
            p.b_rz.data_ptr(), p.b_in.data_ptr(), p.b_hn.data_ptr(), out.data_ptr(),
            B, in_dim, H, gru_plan(B, in_dim, H).tile, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gru_cell kernel failed: CUDA error {err} "
                           f"({lib.zeggs_gru_cell_error_string(err).decode()})")
    profiling.count("gru_cell.launches")
    return out
