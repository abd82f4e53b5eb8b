"""Whole B=1 decoder rollout in one launch: the CUDA kernel
(csrc/decoder_rollout.cu), its weight packer, its plain PyTorch version and
its launch count.

Replaces `zeggs_tpu/ops/pallas/decoder_kernel.py::rollout_fused_b1`. Each of
the T-1 steps rotates the gaze into the root frame and normalises the
input, runs layer0+ELU, GRU0, GRU1 and the output projection, denormalises,
integrates the root and emits one row [pose_out | root_pos | root_rot].

Numerics shared by the kernel and `rollout_b1_plain`:
  * with float32 or bf16 weights every activation is rounded to the weight
    dtype before its product, and products accumulate in float32;
  * with int8 weights (one float32 scale per packed row) each of the six
    activation vectors of a step is quantized once with one symmetric
    scale, s = max(max|x|, 1e-8) / 127, q = clip(round(x / s), -127, 127),
    round half to even; a product is an exact integer sum, dequantized as
    acc * (s * s_row);
  * gates, hidden states, pose and root stay float32;
  * the input is normalised by multiplying with 1/std;
  * ELU is exp(x) - 1;
  * the root rotation is updated as dq * rq, with the reference kernel's
    small-angle branch of the quaternion exp.

The speech/style projections (`cond_l0`, `cond_g0`) are one product over
all frames before the launch, in the weight dtype, then cast to float32
and given their bias; the initial hidden state comes from the cell-state
encoder; frame 0 is the input state and the kernel emits rows 1..T-1.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ...models.layers import gru_gates
from .. import quat
from . import build

#: launches of the CUDA kernel in this process; the plain version on CPU
#: tensors does not count
launches = 0

#: weight dtype -> the kernel's instantiation
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


@dataclasses.dataclass
class PackedDecoder:
    """The ``normal`` cell packed for the kernel, every matrix (N, K) with
    K contiguous so that one warp reads one output column with 16-byte
    loads. K is padded with zeros to a multiple of 8 (16 for int8) (kx)
    for alignment.

      wx (4H, kx):      rows [0, H) layer0 pose columns,
                        rows [H, 4H) GRU0 input-product pose columns
      wh (12H + PO, H): GRU0 hidden part | GRU0 w_hh | GRU1 w_ih | GRU1 w_hh
                        (3H rows each) | output projection (PO rows)
      gbias (3, 3H):    GRU0 b_hh, GRU1 b_ih, GRU1 b_hh
      stats (4, PI):    in_mean, 1/in_std, out_std, out_mean (zero padded)
      sx (4H), sh (12H + PO): float32 row scales of int8 wx and wh
                        (max|row| / 127, 1 for an all-zero row); ones for
                        float weights
    """

    wx: torch.Tensor
    wh: torch.Tensor
    sx: torch.Tensor
    sh: torch.Tensor
    gbias: torch.Tensor
    bout: torch.Tensor
    stats: torch.Tensor
    w_cond_l0: torch.Tensor  # (H, S+C) speech|style columns of layer0
    b_l0: torch.Tensor
    w_cond_g0: torch.Tensor  # (3H, S+C) speech|style columns of GRU0's input product
    b_g0: torch.Tensor
    pose_in: int
    pose_out: int
    hidden: int

    @property
    def kx(self):
        return self.wx.shape[1]


def _round_up(n, m):
    return (n + m - 1) // m * m


def _quantize_rows(m):
    """Symmetric int8 rows with one float32 scale each: the JAX packer's
    per-output-column scale in the port's (N, K) layout."""
    s = m.abs().amax(dim=1) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.round(m / s[:, None]).to(torch.int8), s


def quantize_act(x):
    """One activation vector -> (int8 values as float32, scale): the
    kernel's per-step quantization."""
    s = torch.clamp(x.abs().max(), min=1e-8) / 127.0
    return torch.clamp(torch.round(x / s), -127.0, 127.0), s


@torch.no_grad()
def pack_decoder(cell, anim_input_mean, anim_input_std, anim_output_mean, anim_output_std,
                 weights_dtype=torch.bfloat16):
    """Pack a `models.decoder.NormalCell` and the pose statistics once per
    model. ``weights_dtype`` is torch.bfloat16, torch.float32 or torch.int8;
    with int8 the hoisted speech/style projections stay bf16."""
    if weights_dtype not in _KINDS:
        raise ValueError(f"weights_dtype must be bfloat16, float32 or int8, got {weights_dtype}")
    quantized = weights_dtype == torch.int8
    dev = cell.out.weight.device
    H = cell.gru1.weight_hh.shape[1]
    PI = anim_input_mean.shape[-1]
    PO = cell.out.weight.shape[0]
    f32 = torch.float32
    w0 = cell.layer0.weight.to(f32)
    wg = cell.gru0.weight_ih.to(f32)

    wx = torch.zeros((4 * H, _round_up(PI, 16 if quantized else 8)), dtype=f32, device=dev)
    wx[:H, :PI] = w0[:, :PI]
    wx[H:, :PI] = wg[:, H : H + PI]
    wh = torch.cat([
        wg[:, :H], cell.gru0.weight_hh.to(f32), cell.gru1.weight_ih.to(f32),
        cell.gru1.weight_hh.to(f32), cell.out.weight.to(f32),
    ])
    stats = torch.zeros((4, PI), dtype=f32, device=dev)
    stats[0] = anim_input_mean.to(f32)
    stats[1] = 1.0 / anim_input_std.to(f32)
    stats[2, :PO] = anim_output_std.to(f32)
    stats[3, :PO] = anim_output_mean.to(f32)
    if quantized:
        (wx, sx), (wh, sh) = _quantize_rows(wx), _quantize_rows(wh)
        cond_dtype = torch.bfloat16
    else:
        sx = torch.ones(wx.shape[0], dtype=f32, device=dev)
        sh = torch.ones(wh.shape[0], dtype=f32, device=dev)
        cond_dtype = weights_dtype
    return PackedDecoder(
        wx=wx.to(weights_dtype).contiguous(),
        wh=wh.to(weights_dtype).contiguous(),
        sx=sx.contiguous(),
        sh=sh.contiguous(),
        gbias=torch.stack([cell.gru0.bias_hh, cell.gru1.bias_ih, cell.gru1.bias_hh]).to(f32),
        bout=cell.out.bias.to(f32).contiguous(),
        stats=stats,
        w_cond_l0=w0[:, PI:].to(cond_dtype).contiguous(),
        b_l0=cell.layer0.bias.to(f32),
        w_cond_g0=wg[:, H + PI :].to(cond_dtype).contiguous(),
        b_g0=cell.gru0.bias_ih.to(f32),
        pose_in=PI, pose_out=PO, hidden=H,
    )


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def _from_helical(v, eps=1e-5):
    """exp(v/2) as the reference kernel computes it: [cos|h|, h sin|h|/|h|],
    or [1, h]/sqrt(1+|h|^2) when |h| < eps."""
    h = v * 0.5
    sq = h[0] * h[0] + h[1] * h[1] + h[2] * h[2]
    ha = torch.sqrt(sq)
    small = ha < eps
    sinc = torch.where(small, torch.ones_like(ha), torch.sin(ha) / torch.where(small, torch.ones_like(ha), ha))
    big = torch.cat([torch.cos(ha)[None], h * sinc])
    tn = 1.0 / torch.sqrt(1.0 + sq)
    tiny = torch.cat([tn[None], h * tn])
    return torch.where(small, tiny, big)


@torch.no_grad()
def rollout_b1_plain(packed: PackedDecoder, cond_l0, cond_g0, gaze, p0, h_init, root0, dt):
    """The kernel's function in PyTorch, step by step: the same packed
    weights, the same activation rounding or quantization, float32 sums
    (int8 products summed exactly, in float64). Returns the
    (T-1, pose_out + 7) rows."""
    H, PI, PO = packed.hidden, packed.pose_in, packed.pose_out
    G = 3 * H
    wdt = packed.wx.dtype
    if wdt == torch.int8:
        wx, wh = packed.wx.double()[:, :PI], packed.wh.double()

        def dot(w, s, v):
            q, sa = quantize_act(v)
            return (w @ q.double()).float() * (sa * s)
    else:
        wx, wh = packed.wx.float()[:, :PI], packed.wh.float()

        def dot(w, s, v):
            return w @ v.to(wdt).float()

    def rows_of(lo, hi):
        return wh[lo:hi], packed.sh[lo:hi]

    w_l0, w_g0x = (wx[:H], packed.sx[:H]), (wx[H:], packed.sx[H:])
    w_g0h, w_g0hh, w_g1ih, w_g1hh, w_out = (
        rows_of(0, G), rows_of(G, 2 * G), rows_of(2 * G, 3 * G), rows_of(3 * G, 4 * G),
        rows_of(4 * G, 4 * G + PO),
    )
    in_mean, in_rstd = packed.stats[0], packed.stats[1]
    out_std, out_mean = packed.stats[2, :PO], packed.stats[3, :PO]
    b_hh0, b_ih1, b_hh1 = packed.gbias

    pose, h0, h1 = p0, h_init[0], h_init[1]
    rp, rq = root0[:3], root0[3:7]
    rows = []
    for t in range(cond_l0.shape[0]):
        gd = quat.inv_mul_vec(rq, gaze[t] - rp)
        x = (torch.cat([pose, gd]) - in_mean) * in_rstd
        pre = cond_l0[t] + dot(*w_l0, x)
        hidden = torch.where(pre > 0.0, pre, torch.exp(pre) - 1.0)
        gi = (cond_g0[t] + dot(*w_g0x, x)) + dot(*w_g0h, hidden)
        gh = dot(*w_g0hh, h0) + b_hh0
        h0 = gru_gates(gi, gh, h0)
        gi1 = dot(*w_g1ih, h0) + b_ih1
        gh1 = dot(*w_g1hh, h1) + b_hh1
        h1 = gru_gates(gi1, gh1, h1)
        pose = (dot(*w_out, h1) + packed.bout) * out_std + out_mean
        rp = rp + quat.mul_vec(rq, pose[0:3] * dt)
        rq = quat.mul(_from_helical(quat.mul_vec(rq, pose[3:6] * dt)), rq)
        rows.append(torch.cat([pose, rp, rq]))
    if not rows:
        return p0.new_zeros((0, PO + 7))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _check(packed: PackedDecoder, cond_l0, cond_g0, gaze, p0, h_init, root0):
    H, PO = packed.hidden, packed.pose_out
    T1 = cond_l0.shape[0]
    if packed.wx.dtype not in _KINDS or packed.wh.dtype != packed.wx.dtype:
        raise TypeError(f"packed weights must be float32, bfloat16 or int8, got {packed.wx.dtype}")
    align = 16 if packed.wx.dtype == torch.int8 else 8
    if H % align or packed.kx % align:
        raise ValueError(f"hidden size {H} and packed width {packed.kx} must be multiples of "
                         f"{align} for {packed.wx.dtype} weights")
    expected = {
        "wx": (packed.wx, (4 * H, packed.kx)),
        "wh": (packed.wh, (12 * H + PO, H)),
        "sx": (packed.sx, (4 * H,)),
        "sh": (packed.sh, (12 * H + PO,)),
        "gbias": (packed.gbias, (3, 3 * H)),
        "bout": (packed.bout, (PO,)),
        "stats": (packed.stats, (4, packed.pose_in)),
        "cond_l0": (cond_l0, (T1, H)),
        "cond_g0": (cond_g0, (T1, 3 * H)),
        "gaze": (gaze, (T1, 3)),
        "p0": (p0, (PO,)),
        "h_init": (h_init, (2, H)),
        "root0": (root0, (7,)),
    }
    dev = packed.wx.device
    for name, (t, shape) in expected.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the packed weights on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name not in ("wx", "wh") and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if packed.pose_in != PO + 3:
        raise ValueError(f"pose_in {packed.pose_in} must be pose_out {PO} + 3 (gaze)")


@functools.cache
def _library():
    lib = build.load("decoder_rollout")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.zeggs_decoder_rollout.argtypes = [i] + [p] * 15 + [i] * 5 + [ctypes.c_float, p]
    lib.zeggs_decoder_rollout.restype = i
    lib.zeggs_decoder_rollout_grid.argtypes = [i, i, i]
    lib.zeggs_decoder_rollout_grid.restype = i
    lib.zeggs_cuda_error_string.argtypes = [i]
    lib.zeggs_cuda_error_string.restype = ctypes.c_char_p
    return lib


def scratch_floats(hidden, pose_out):
    """Device scratch of one launch: pose[2][PO], h0[2][H], h1[2][H] (the
    carried state, double-buffered by step parity) and the 10H
    phase-1 products."""
    return 2 * pose_out + 14 * hidden


def grid_blocks(packed: PackedDecoder):
    """Blocks the kernel launches on the current card (all resident at
    once); raises if it cannot be launched cooperatively."""
    lib = _library()
    n = lib.zeggs_decoder_rollout_grid(_KINDS[packed.wx.dtype], packed.hidden, packed.kx)
    if n <= 0:
        raise RuntimeError(f"decoder_rollout cannot launch: {lib.zeggs_cuda_error_string(-n).decode()}")
    return n


def rollout_b1(packed: PackedDecoder, cond_l0, cond_g0, gaze, p0, h_init, root0, dt):
    """Run the T-1 decoder steps -> (T-1, pose_out + 7) rows
    [pose_out | root_pos | root_rot]. CUDA tensors launch the kernel once;
    CPU tensors take `rollout_b1_plain`. Raises on anything the kernel does
    not take and on any CUDA error."""
    global launches
    _check(packed, cond_l0, cond_g0, gaze, p0, h_init, root0)
    dev = packed.wx.device
    if dev.type == "cpu":
        return rollout_b1_plain(packed, cond_l0, cond_g0, gaze, p0, h_init, root0, dt)
    if dev.type != "cuda":
        raise ValueError(f"decoder_rollout runs on cuda or cpu tensors, not {dev}")
    H, PO = packed.hidden, packed.pose_out
    T1 = cond_l0.shape[0]
    if T1 == 0:  # a one-frame request: nothing to roll out, nothing launched
        return torch.empty((0, PO + 7), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        out = torch.empty((T1, PO + 7), dtype=torch.float32, device=dev)
        scratch = torch.empty((scratch_floats(H, PO),), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zeggs_decoder_rollout(
            _KINDS[packed.wx.dtype],
            packed.wx.data_ptr(), packed.wh.data_ptr(), packed.sx.data_ptr(),
            packed.sh.data_ptr(), packed.gbias.data_ptr(),
            packed.bout.data_ptr(), packed.stats.data_ptr(), cond_l0.data_ptr(),
            cond_g0.data_ptr(), gaze.data_ptr(), p0.data_ptr(), h_init.data_ptr(),
            root0.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            T1, H, packed.pose_in, PO, packed.kx, float(dt), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"decoder_rollout kernel failed: CUDA error {err} "
            f"({lib.zeggs_cuda_error_string(err).decode()})"
        )
    launches += 1
    return out


def conditioning(packed: PackedDecoder, speech_encoding, style_encoding):
    """The hoisted speech/style projections over frames 1..T-1: one
    product in the weight dtype, cast to float32, plus the bias."""
    cond = torch.cat([speech_encoding[0, 1:], style_encoding[0, 1:]], dim=-1)
    cond = cond.to(packed.w_cond_l0.dtype)
    cond_l0 = (cond @ packed.w_cond_l0.T).float() + packed.b_l0
    cond_g0 = (cond @ packed.w_cond_g0.T).float() + packed.b_g0
    return cond_l0.contiguous(), cond_g0.contiguous()


def rollout_fused_b1(packed: PackedDecoder, h_init, root_pos, root_rot, root_vel, root_vrt,
                     lpos, ltxy, lvel, lvrt, gaze_pos, speech_encoding, style_encoding, dt):
    """B=1 rollout. Frame-0 state (1, ...), conditioning (1, T, ...),
    ``h_init`` (2, H) from the cell-state encoder. Returns the 8
    trajectories (1, T, ...) with frame 0 equal to the inputs, as
    `models.decoder.rollout` does."""
    if speech_encoding.shape[0] != 1:
        raise ValueError("the fused rollout is the B=1 path")
    njoints = lpos.shape[1]
    cond_l0, cond_g0 = conditioning(packed, speech_encoding, style_encoding)
    p0 = torch.cat([x.reshape(-1) for x in (root_vel, root_vrt, lpos, ltxy, lvel, lvrt)])
    root0 = torch.cat([root_pos[0], root_rot[0]])
    rows = rollout_b1(
        packed, cond_l0, cond_g0, gaze_pos[0, 1:].contiguous(), p0.float().contiguous(),
        h_init.float().contiguous(), root0.float().contiguous(), dt,
    )
    PO, J3 = packed.pose_out, njoints * 3
    o = 6
    seq = (
        rows[:, PO : PO + 3],
        rows[:, PO + 3 : PO + 7],
        rows[:, 0:3],
        rows[:, 3:6],
        rows[:, o : o + J3].reshape(-1, njoints, 3),
        rows[:, o + J3 : o + 3 * J3].reshape(-1, njoints, 2, 3),
        rows[:, o + 3 * J3 : o + 4 * J3].reshape(-1, njoints, 3),
        rows[:, o + 4 * J3 : o + 5 * J3].reshape(-1, njoints, 3),
    )
    firsts = (root_pos, root_rot, root_vel, root_vrt, lpos, ltxy, lvel, lvrt)
    return tuple(torch.cat([f[:, None], s[None]], dim=1) for f, s in zip(firsts, seq))
