"""Whole B=1 decoder rollout in one launch: the CUDA kernel
(csrc/decoder_rollout.cu), its weight packer and its plain PyTorch version.
Each launch counts one ``decoder_rollout.launches`` (`utils.profiling`); the
plain version counts nothing.

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
import heapq

import numpy as np
import torch

from ...models.layers import gru_gates
from ...utils import profiling
from .. import quat
from . import build

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
    #: (blocks, shared memory budget) -> RolloutPlan on the weights' device
    plans: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

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
# the plan: which rows each block of the persistent grid owns, and keeps
# ---------------------------------------------------------------------------

#: threads of a block of the kernel (csrc/decoder_rollout.cu), one block per SM
THREADS = 512
#: shared memory a block of an H100 may use (227 KB, opt-in)
SMEM_BUDGET = 232448
#: ints of a block's table header
_HDR = 12


@dataclasses.dataclass
class RolloutPlan:
    """How the kernel's grid shares the packed rows, for one weight dtype.

    Phases of a step and their rows (``r,z,n`` of a GRU unit are three rows
    of one block, next to each other):
      0: GRU0 input-product pose rows (wx H + gH + j) of the block's GRU0
         units, then layer0 rows (wx k);
      1: GRU0 hidden-part rows (wh gH + j);
      2: GRU1 w_ih rows (wh 2G + gH + j) of its GRU1 units, then GRU0 w_hh
         rows (wh G + gH + j) of its GRU0 units, for the next step;
      3: GRU1 w_hh rows (wh 3G + gH + j) of its GRU1 units, for the next
         step, then output rows (wh 4G + c).
    ``table[b]``: n_rows[4], n_streamed[4], n_gru0, n_gru1, end of the
    resident rows, staging bytes; then per phase the rows' packed index
    [mr], their shared-memory byte offset [mr] and the indices of the
    streamed rows [mr]. A resident row is copied once, at t = 0; a streamed
    row is copied from L2 into the staging area before the barrier that
    precedes its phase, every step.
    """

    blocks: int
    mr: int  # row slots of a phase in a block
    base: int  # bytes of shared memory before the weights
    smem_bytes: int  # the launch's dynamic shared memory
    table: torch.Tensor  # (blocks, _HDR + 12 mr) int32
    weight_bytes: int
    resident_bytes: int  # over all blocks
    streamed_bytes: int  # a step, over all blocks
    staging_bytes: int  # the largest staging area of a block

    @property
    def resident_share(self):
        return self.resident_bytes / self.weight_bytes


def fixed_smem_bytes(kx, hidden, mr):
    """Shared memory before the weights (csrc/decoder_rollout.cu `layout`):
    the activation as floats and as int8, the row products and row scales
    [4][mr], the epilogues' constants and state [9][mr], the block's table,
    and the root, gaze and block reductions."""
    n = _round_up(max(kx, hidden), 16)
    return _round_up(5 * n + 32 * mr + 36 * mr + 4 * (_HDR + 12 * mr) + 4 * 32, 128)


def _even_split(n, parts, reverse=False):
    q, r = divmod(n, parts)
    sizes = [q + (1 if i < r else 0) for i in range(parts)]
    return sizes[::-1] if reverse else sizes


def _spread(rows, loads, dest):
    """Give each row to the block with the fewest rows so far."""
    heap = [(loads[b], b) for b in range(len(loads))]
    heapq.heapify(heap)
    for r in rows:
        n, b = heapq.heappop(heap)
        dest[b].append(r)
        heapq.heappush(heap, (n + 1, b))


def plan_rollout(hidden, kx, pose_out, weights_dtype, blocks=132, smem_budget=SMEM_BUDGET):
    """Assign every packed row to one block, evenly per phase, and keep as
    many as fit resident in each block's shared memory; the rest are
    staged a phase at a time. Raises ValueError when a phase's rows cannot
    be staged within the budget."""
    H, G = hidden, 3 * hidden
    if max(kx, H) > 3 * THREADS:
        raise ValueError(f"decoder plan does not fit: widths {kx} and {H} exceed the kernel's "
                         f"{3 * THREADS} (three values a thread)")
    es = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}[weights_dtype]
    n0s, n1s = _even_split(H, blocks), _even_split(H, blocks, reverse=True)
    phases = [[[] for _ in range(blocks)] for _ in range(4)]
    j0 = j1 = 0
    for b in range(blocks):
        u0, u1 = range(j0, j0 + n0s[b]), range(j1, j1 + n1s[b])
        j0, j1 = j0 + n0s[b], j1 + n1s[b]
        phases[0][b] = [H + g * H + j for j in u0 for g in range(3)]
        phases[1][b] = [g * H + j for j in u0 for g in range(3)]
        phases[2][b] = ([2 * G + g * H + j for j in u1 for g in range(3)]
                        + [G + g * H + j for j in u0 for g in range(3)])
        phases[3][b] = [3 * G + g * H + j for j in u1 for g in range(3)]
    _spread(range(H), [len(r) for r in phases[0]], phases[0])
    _spread([4 * G + c for c in range(pose_out)], [len(r) for r in phases[3]], phases[3])

    rb = [kx * es, H * es, H * es, H * es]
    if any(r % 16 for r in rb):
        raise ValueError(f"rows of {rb} bytes: 16-byte copies need multiples of 16")
    mr = max(len(r) for ph in phases for r in ph)
    base = fixed_smem_bytes(kx, H, mr)
    avail = smem_budget - base
    table = np.zeros((blocks, _HDR + 12 * mr), dtype=np.int32)
    resident = streamed = staging_max = 0
    for b in range(blocks):
        n = [len(phases[p][b]) for p in range(4)]
        total = sum(n[p] * rb[p] for p in range(4))
        cap = 0  # staging bytes: the smallest that leaves the rest resident
        while total - (avail - cap) > sum(min(n[p], cap // rb[p]) * rb[p] for p in range(4)):
            cap += min(rb)
            if cap > avail:
                raise ValueError(
                    f"decoder plan does not fit: block {b} holds {total} bytes of "
                    f"{weights_dtype} rows, phases of {[n[p] * rb[p] for p in range(4)]} bytes, "
                    f"in {avail} bytes of shared memory")
        need = max(0, total - (avail - cap))
        ns = [0] * 4
        while sum(ns[p] * rb[p] for p in range(4)) < need:
            p = min((q for q in range(4) if ns[q] < n[q] and (ns[q] + 1) * rb[q] <= cap),
                    key=lambda q: ns[q] * rb[q])
            ns[p] += 1
        res_end = base
        hdr = n + ns + [n0s[b], n1s[b], 0, 0]
        for p in range(4):
            row = _HDR + 3 * mr * p
            for i, g in enumerate(phases[p][b]):
                table[b, row + i] = g
                if i < n[p] - ns[p]:
                    table[b, row + mr + i] = res_end
                    res_end += rb[p]
            table[b, row + 2 * mr : row + 2 * mr + ns[p]] = range(n[p] - ns[p], n[p])
        stage_end = res_end
        for p in range(4):
            row = _HDR + 3 * mr * p
            for k in range(ns[p]):
                table[b, row + mr + n[p] - ns[p] + k] = res_end + k * rb[p]
            stage_end = max(stage_end, res_end + ns[p] * rb[p])
        assert stage_end <= smem_budget
        hdr[10], hdr[11] = res_end, stage_end - res_end
        table[b, :_HDR] = hdr
        resident += res_end - base
        streamed += sum(ns[p] * rb[p] for p in range(4))
        staging_max = max(staging_max, stage_end - res_end)
    weight_bytes = (4 * H * kx + (12 * H + pose_out) * H) * es
    assert resident + streamed == weight_bytes
    return RolloutPlan(blocks=blocks, mr=mr, base=base, smem_bytes=smem_budget,
                       table=torch.from_numpy(table),
                       weight_bytes=weight_bytes, resident_bytes=resident,
                       streamed_bytes=streamed, staging_bytes=staging_max)


def rollout_plan(packed: PackedDecoder, blocks=132, smem_budget=SMEM_BUDGET):
    """`plan_rollout` for ``packed``, cached on it, its table on the
    weights' device."""
    key = (blocks, smem_budget)
    if key not in packed.plans:
        plan = plan_rollout(packed.hidden, packed.kx, packed.pose_out, packed.wx.dtype, blocks,
                            smem_budget)
        plan.table = plan.table.to(packed.wx.device)
        packed.plans[key] = plan
    return packed.plans[key]


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
    lib.zeggs_decoder_rollout.argtypes = [i] + [p] * 16 + [i] * 9 + [ctypes.c_float, p]
    lib.zeggs_decoder_rollout.restype = i
    lib.zeggs_decoder_rollout_grid.argtypes = [i, i]
    lib.zeggs_decoder_rollout_grid.restype = i
    lib.zeggs_decoder_smem_optin.argtypes = []
    lib.zeggs_decoder_smem_optin.restype = i
    lib.zeggs_decoder_barrier_floor.argtypes = [i, p, i, i, p]
    lib.zeggs_decoder_barrier_floor.restype = i
    lib.zeggs_cuda_error_string.argtypes = [i]
    lib.zeggs_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raise_for(err, what):
    if err != 0:
        msg = _library().zeggs_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


def scratch_floats(hidden, pose_out):
    """Device scratch of one launch: pose[2][PO], h0[2][H], h1[2][H] (the
    carried state, double-buffered by step parity), the H layer0 products,
    and the grid barrier's word (zeroed)."""
    return 2 * pose_out + 5 * hidden + 1


def card_smem_budget():
    """Shared memory a block may use on the current card (227 KB on an
    H100); raises if it cannot be read."""
    n = _library().zeggs_decoder_smem_optin()
    if n <= 0:
        _raise_for(-n, "reading the shared memory limit")
    return n


def grid_blocks(packed: PackedDecoder):
    """Blocks the kernel launches on the current card: one per SM, all
    resident at once; raises if it cannot be launched cooperatively with
    one block of the full budget per SM."""
    n = _library().zeggs_decoder_rollout_grid(_KINDS[packed.wx.dtype], card_smem_budget())
    if n <= 0:
        raise RuntimeError("decoder_rollout cannot launch one resident block per SM: "
                           f"{_library().zeggs_cuda_error_string(-n).decode()}")
    return n


def card_plan(packed: PackedDecoder):
    """The plan for ``packed`` on the current card; raises ValueError if its
    rows cannot be staged within the card's shared memory."""
    return rollout_plan(packed, grid_blocks(packed), card_smem_budget())


def rollout_b1(packed: PackedDecoder, cond_l0, cond_g0, gaze, p0, h_init, root0, dt):
    """Run the T-1 decoder steps -> (T-1, pose_out + 7) rows
    [pose_out | root_pos | root_rot]. CUDA tensors launch the kernel once;
    CPU tensors take `rollout_b1_plain`. Raises on anything the kernel does
    not take, on a plan that does not fit the card, and on any CUDA error."""
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
        plan = card_plan(packed)
        out = torch.empty((T1, PO + 7), dtype=torch.float32, device=dev)
        scratch = torch.zeros((scratch_floats(H, PO),), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.zeggs_decoder_rollout(
            _KINDS[packed.wx.dtype],
            packed.wx.data_ptr(), packed.wh.data_ptr(), packed.sx.data_ptr(),
            packed.sh.data_ptr(), packed.gbias.data_ptr(),
            packed.bout.data_ptr(), packed.stats.data_ptr(), cond_l0.data_ptr(),
            cond_g0.data_ptr(), gaze.data_ptr(), p0.data_ptr(), h_init.data_ptr(),
            root0.data_ptr(), out.data_ptr(), scratch.data_ptr(), plan.table.data_ptr(),
            T1, H, packed.pose_in, PO, packed.kx, plan.mr, plan.base, plan.blocks,
            plan.smem_bytes, float(dt), stream,
        )
    _raise_for(err, "decoder_rollout kernel")
    profiling.count("decoder_rollout.launches")
    return out


def barrier_floor(steps, barrier="grid", device="cuda"):
    """Launch ``steps`` x 4 grid barriers and nothing else on the rollout's
    grid (one block of the full shared-memory budget per SM): ``barrier``
    "grid" is the kernel's own, "cg" cooperative groups' grid sync. The
    floor of a rollout of ``steps`` steps; not a launch of the rollout."""
    lib = _library()
    dev = torch.device(device)
    with torch.cuda.device(dev):
        sync = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.zeggs_decoder_barrier_floor({"grid": 0, "cg": 1}[barrier], sync.data_ptr(),
                                              steps, card_smem_budget(),
                                              torch.cuda.current_stream(dev).cuda_stream)
    _raise_for(err, "barrier floor kernel")
    return sync


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
