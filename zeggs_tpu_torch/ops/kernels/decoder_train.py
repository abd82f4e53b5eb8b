"""The ``normal`` decoder cell's training rollout as one autograd Function:
backward through time written by hand, with the step kernels of
csrc/decoder_train.cu, their plain PyTorch versions and their launch count.

This is the design of cuDNN's RNNs: the recurrence stays a loop over
frames, and whatever is not recurrent leaves the loop. Each frame runs
cuBLAS products (`torch.mm`) and, between them, a few fused kernels:

  forward   pose   denormalise the last frame's output, integrate the root
                   (quaternion products, `from_helical` with its eps), write
                   the frame's trajectories; rotate the gaze into root space
                   and normalise the next frame's input
            elu    layer0's speech/style part + its pose product, ELU;
                   keeps the pre-activation for the backward
            gru    a GRU layer's gates from its products (biases inside
                   them); writes h' and keeps r, z, n and W_hn h + b_hn
  backward  the mirrored kernels, in reverse, carrying d root_pos,
            d root_rot, dh0 and dh1 back through time; the products give
            the input gradients only.

The forward keeps what the backward needs in (T, B, ...) buffers (each
frame's slice contiguous). After the backward loop each of the seven
weights' gradients is one product over all B*T rows and each bias's one
sum: nothing is accumulated frame by frame.

The forward is the plain step's (`models.decoder.chunk_step`) to the bit:
the same cuBLAS products on the same views, and kernels that round each
operation as PyTorch's operators do (gaze rotated into root space and
normalised with the pose, ELU, GRUs with separate b_in and b_hn, eps 1e-5
in `from_helical`, all float32). So the loss sees the same trajectories,
and the L1 terms the same signs; the backward differs from autograd's only
in the order of its sums.

`rollout_bptt` is the entry point; `models.decoder.rollout_chunk` calls it
where autograd records on the decoder at float32 compute with neither
remat, int8 nor ``output_indices``. On CPU tensors every step op is its
plain PyTorch version (`PlainOps`, any float dtype); on CUDA tensors the
kernels run (`CudaOps`, float32), and anything they do not take raises.

Counts (`utils.profiling`): each kernel launch counts one
``decoder_train.launches``; ``decoder_bptt.forwards`` and
``decoder_bptt.backwards`` count the Function's passes, on either device.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ...models.layers import gru_gates
from ...utils import profiling
from .. import quat
from . import build

# -- the backward of `ops/quat.py`'s functions --------------------------------

def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def _mul_bwd(x, y, g):
    """(dx, dy) of `quat.mul` under the output's gradient g."""
    x0, x1, x2, x3 = x.unbind(-1)
    y0, y1, y2, y3 = y.unbind(-1)
    g0, g1, g2, g3 = g.unbind(-1)
    dx = torch.stack([g0 * y0 + g1 * y1 + g2 * y2 + g3 * y3,
                      -g0 * y1 + g1 * y0 - g2 * y3 + g3 * y2,
                      -g0 * y2 + g1 * y3 + g2 * y0 - g3 * y1,
                      -g0 * y3 - g1 * y2 + g2 * y1 + g3 * y0], dim=-1)
    dy = torch.stack([g0 * x0 + g1 * x1 + g2 * x2 + g3 * x3,
                      -g0 * x1 + g1 * x0 + g2 * x3 - g3 * x2,
                      -g0 * x2 - g1 * x3 + g2 * x0 + g3 * x1,
                      -g0 * x3 + g1 * x2 - g2 * x1 + g3 * x0], dim=-1)
    return dx, dy


def _mul_vec_bwd(q, v, g):
    """(dq, dv) of `quat.mul_vec` under the output's gradient g."""
    u, w = q[..., 1:], q[..., :1]
    t = 2.0 * _cross(u, v)
    dt = w * g + _cross(g, u)
    du = _cross(t, g) + 2.0 * _cross(v, dt)
    dv = g + 2.0 * _cross(dt, u)
    return torch.cat([_dot(g, t), du], dim=-1), dv


def _exp_bwd(x, g, eps=1e-5):
    """dx of `quat.exp` under the output's gradient g."""
    ha = torch.sqrt((x * x).sum(-1, keepdim=True))
    small = ha < eps
    safe = torch.where(small, torch.ones_like(ha), ha)
    s, c = torch.sin(safe), torch.cos(safe)
    sinc = torch.sinc(safe / math.pi)
    dha = -s * g[..., :1] + _dot(g[..., 1:], x) * (safe * c - s) / (safe * safe)
    d_big = sinc * g[..., 1:] + dha * x / safe
    cc = torch.cat([torch.ones_like(ha), x], dim=-1)
    norm = torch.sqrt((cc * cc).sum(-1, keepdim=True))
    n = norm + eps
    d_tiny = (g / n - cc * _dot(g, cc) / (n * n * norm))[..., 1:]
    return torch.where(small, d_tiny, d_big)


# -- the step ops ------------------------------------------------------------

class PlainOps:
    """Each kernel's function in PyTorch, on any device and float dtype. An
    op writes its results into the views it is given, as the kernel does.
    The forward ops are the plain step's own (`ops.quat`,
    `models.layers.gru_gates`, the pose's denormalisation and
    normalisation)."""

    @staticmethod
    def pose_fwd(out, mean_out, std_out, x0, rp_prev, rr_prev, p_dst, rp_dst, rr_dst, gaze,
                 mean_in, std_in, pose_dst, dt):
        """With ``out`` (the last frame's output product, B x D): p = out
        std_out + mean_out into ``p_dst``, and the root integrated from
        (``rp_prev``, ``rr_prev``) into ``rp_dst``, ``rr_dst``. Without it,
        the state is (``x0``, ``rp_prev``, ``rr_prev``). With ``pose_dst``:
        the next input, ([x | gaze in root space] - mean_in) / std_in."""
        if out is not None:
            x = out * std_out + mean_out
            rp = quat.mul_vec(rr_prev, x[:, 0:3] * dt) + rp_prev
            rr = quat.mul(quat.from_helical(quat.mul_vec(rr_prev, x[:, 3:6] * dt)), rr_prev)
            p_dst.copy_(x)
            rp_dst.copy_(rp)
            rr_dst.copy_(rr)
        else:
            x, rp, rr = x0, rp_prev, rr_prev
        if pose_dst is not None:
            gd = quat.inv_mul_vec(rr, gaze - rp)
            pose_dst.copy_((torch.cat([x, gd], dim=-1) - mean_in) / std_in)

    @staticmethod
    def elu_fwd(pre, a, act, hid):
        """act = pre + a; hid = elu(act)."""
        act.copy_(pre + a)
        hid.copy_(F.elu(act))

    @staticmethod
    def gru_fwd(s0, s1, s2, gh, h, h_new, gates):
        """gi = s0 (+ s1) (+ s2); PyTorch's GRU gates from gi and gh (the
        products with their biases) into ``h_new``, and [r | z | n | gh_n]
        into ``gates``."""
        H = h.shape[-1]
        gi = s0
        for s in (s1, s2):
            if s is not None:
                gi = gi + s
        h_new.copy_(gru_gates(gi, gh, h))
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H : 2 * H] + gh[:, H : 2 * H])
        ghn = gh[:, 2 * H :]
        gates.copy_(torch.cat([r, z, torch.tanh(gi[:, 2 * H :] + r * ghn), ghn], dim=-1))

    @staticmethod
    def gru_bwd(dh, gates, h, dgi, dgh):
        """From dh' (``dh``, replaced by its direct part z dh'): the gate
        gradients dgi = [dr, dz, dn] and dgh = [dr, dz, dn r] (pre-activation)."""
        H = h.shape[-1]
        r, z, n, ghn = gates[:, :H], gates[:, H : 2 * H], gates[:, 2 * H : 3 * H], gates[:, 3 * H :]
        dnp = dh * (1.0 - z) * (1.0 - n * n)
        dzp = dh * (h - n) * (1.0 - z) * z
        drp = dnp * ghn * (1.0 - r) * r
        dgi.copy_(torch.cat([drp, dzp, dnp], dim=-1))
        dgh.copy_(torch.cat([drp, dzp, dnp * r], dim=-1))
        dh.mul_(z)

    @staticmethod
    def elu_bwd(dhid, act, da):
        """da = dhid * elu'(act): 1 above 0, else exp(act), as autograd's."""
        da.copy_(torch.where(act > 0, dhid, dhid * torch.exp(act)))

    @staticmethod
    def pose_bwd(dpose, std_in, gaze, rp, rr, dgaze, dp_up, drp_up, drr_up, p_prev, rr_prev,
                 std_out, dout, g_rp, g_rr, dx0, dt):
        """The backward of `pose_fwd` at one frame boundary. ``g_rp``,
        ``g_rr`` hold the gradients of this frame's root state (rp, rr) from
        the later frames; with ``dpose`` (this frame's input's gradient) the
        gaze's rotation adds to them and gives ``dgaze``. With ``p_prev``
        (the last frame's output): the upstream gradients of the
        trajectories (``dp_up``, ``drp_up``, ``drr_up``) are added, the
        integration is taken back, ``dout`` = dp std_out, and ``g_rp``,
        ``g_rr`` become the last frame's. Without it (the first frame):
        ``dx0`` takes the carry's pose gradient."""
        D = std_out.shape[0]
        grp, grr = g_rp.clone(), g_rr.clone()
        dx = None
        if dpose is not None:
            dx = dpose[:, :D] / std_in[:D]
            dgd = dpose[:, D:] / std_in[D:]
            dqi, da = _mul_vec_bwd(quat.inv(rr), gaze - rp, dgd)
            grr = grr + quat.inv(dqi)
            grp = grp - da
            dgaze.copy_(da)
        if p_prev is None:
            dx0.copy_(dx if dx is not None else torch.zeros_like(dx0))
            g_rp.copy_(grp)
            g_rr.copy_(grr)
            return
        grp = grp + drp_up
        grr = grr + drr_up
        v, w = p_prev[:, 0:3] * dt, p_prev[:, 3:6] * dt
        e = quat.mul_vec(rr_prev, w)
        dq, drr_a = _mul_bwd(quat.from_helical(e), rr_prev, grr)
        de = _exp_bwd(e / 2.0, dq) / 2.0
        drr_b, dw = _mul_vec_bwd(rr_prev, w, de)
        drr_c, dv = _mul_vec_bwd(rr_prev, v, grp)
        dp = dp_up if dx is None else dp_up + dx
        dp = torch.cat([dp[:, 0:3] + dv * dt, dp[:, 3:6] + dw * dt, dp[:, 6:]], dim=-1)
        dout.copy_(dp * std_out)
        g_rp.copy_(grp)
        g_rr.copy_(drr_a + drr_b + drr_c)


@functools.cache
def _library():
    lib = build.load("decoder_train")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.zeggs_dt_pose_fwd.argtypes = [p] * 4 + [p, i] * 6 + [p] * 3 + [i, i, f, p]
    lib.zeggs_dt_elu_fwd.argtypes = [p, i, p, i, p, p, i, i, p]
    lib.zeggs_dt_gru_fwd.argtypes = [p, i] * 3 + [p, p, i, p, p, i, i, p]
    lib.zeggs_dt_gru_bwd.argtypes = [p, p, p, p, i, p, i, i, i, p]
    lib.zeggs_dt_elu_bwd.argtypes = [p, p, p, i, i, i, p]
    lib.zeggs_dt_pose_bwd.argtypes = [p, p] + [p, i] * 9 + [p] * 5 + [i, i, f, p]
    for fn in ("pose_fwd", "elu_fwd", "gru_fwd", "gru_bwd", "elu_bwd", "pose_bwd"):
        getattr(lib, f"zeggs_dt_{fn}").restype = i
    lib.zeggs_dt_error_string.argtypes = [i]
    lib.zeggs_dt_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t):
    """(pointer, row stride) of a (B, n) float32 view with unit column
    stride, or (None, 0)."""
    if t is None:
        return None, 0
    if t.dtype != torch.float32 or t.device.type != "cuda":
        raise TypeError(f"the decoder_train kernels take float32 CUDA tensors, not {t.dtype} "
                        f"on {t.device}")
    if t.ndim > 2 or (t.ndim == 2 and t.stride(1) != 1):
        raise ValueError(f"the decoder_train kernels take rows of unit stride, not {t.stride()}")
    return t.data_ptr(), t.stride(0) if t.ndim == 2 else 0


def _vec(t):
    """Pointer of a contiguous float32 CUDA vector, or None."""
    if t is None:
        return None
    if t.dtype != torch.float32 or t.device.type != "cuda" or not t.is_contiguous():
        raise TypeError("the decoder_train kernels take contiguous float32 CUDA vectors")
    return t.data_ptr()


def _launch(name, ref, *args):
    """Launch csrc/decoder_train.cu's zeggs_dt_<name> on the current stream
    of ``ref``'s card and count it; raises on a CUDA error."""
    lib = _library()
    with torch.cuda.device(ref.device):
        err = getattr(lib, f"zeggs_dt_{name}")(
            *args, torch.cuda.current_stream(ref.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decoder_train {name} kernel failed: CUDA error {err} "
                           f"({lib.zeggs_dt_error_string(err).decode()})")
    profiling.count("decoder_train.launches")


def _contiguous_rows(*ts):
    """Each (B, n) view must hold contiguous rows (a row stride of n)."""
    for t in ts:
        if t is not None and not t.is_contiguous():
            raise ValueError("the decoder_train kernels take contiguous (B, n) buffers here")


class CudaOps:
    """The same ops as `PlainOps`, each one launch of a kernel of
    csrc/decoder_train.cu (float32 CUDA tensors)."""

    @staticmethod
    def pose_fwd(out, mean_out, std_out, x0, rp_prev, rr_prev, p_dst, rp_dst, rr_dst, gaze,
                 mean_in, std_in, pose_dst, dt):
        _contiguous_rows(out, x0, pose_dst)
        B, D = rp_prev.shape[0], mean_out.shape[0]
        _launch("pose_fwd", rp_prev, _ptr(out)[0], _vec(mean_out), _vec(std_out),
                _ptr(x0)[0], *_ptr(rp_prev), *_ptr(rr_prev), *_ptr(p_dst), *_ptr(rp_dst),
                *_ptr(rr_dst), *_ptr(gaze), _vec(mean_in), _vec(std_in), _ptr(pose_dst)[0],
                B, D, float(dt))

    @staticmethod
    def elu_fwd(pre, a, act, hid):
        _contiguous_rows(act, hid)
        B, H = hid.shape
        _launch("elu_fwd", hid, *_ptr(pre), *_ptr(a), _ptr(act)[0], _ptr(hid)[0], B, H)

    @staticmethod
    def gru_fwd(s0, s1, s2, gh, h, h_new, gates):
        _contiguous_rows(gh, h_new, gates)
        B, H = h.shape
        _launch("gru_fwd", h, *_ptr(s0), *_ptr(s1), *_ptr(s2), _ptr(gh)[0], *_ptr(h),
                _ptr(h_new)[0], _ptr(gates)[0], B, H)

    @staticmethod
    def gru_bwd(dh, gates, h, dgi, dgh):
        _contiguous_rows(dh, gates, h)
        B, H = h.shape
        _launch("gru_bwd", h, _ptr(dh)[0], _ptr(gates)[0], _ptr(h)[0], *_ptr(dgi), *_ptr(dgh),
                B, H)

    @staticmethod
    def elu_bwd(dhid, act, da):
        _contiguous_rows(dhid, act)
        B, H = act.shape
        _launch("elu_bwd", act, _ptr(dhid)[0], _ptr(act)[0], *_ptr(da), B, H)

    @staticmethod
    def pose_bwd(dpose, std_in, gaze, rp, rr, dgaze, dp_up, drp_up, drr_up, p_prev, rr_prev,
                 std_out, dout, g_rp, g_rr, dx0, dt):
        _contiguous_rows(dpose, dout, g_rp, g_rr, dx0)
        B, D = g_rp.shape[0], std_out.shape[0]
        _launch("pose_bwd", g_rp, _ptr(dpose)[0], _vec(std_in), *_ptr(gaze), *_ptr(rp),
                *_ptr(rr), *_ptr(dgaze), *_ptr(dp_up), *_ptr(drp_up), *_ptr(drr_up),
                *_ptr(p_prev), *_ptr(rr_prev), _vec(std_out), _ptr(dout)[0], _ptr(g_rp)[0],
                _ptr(g_rr)[0], _ptr(dx0)[0], B, D, float(dt))


def step_ops(device):
    """The kernels on a card, their plain versions on the CPU."""
    if device.type == "cuda":
        return CudaOps
    if device.type == "cpu":
        return PlainOps
    raise ValueError(f"decoder_train runs on cuda or cpu tensors, not {device}")


# -- the Function --------------------------------------------------------------

class Weights(NamedTuple):
    """The cell's live parameters as the step uses them."""

    w0_pose: torch.Tensor  # (H, pose_in): layer0's pose columns
    wg_pose: torch.Tensor  # (3H, pose_in): GRU0's pose columns
    w_gh: torch.Tensor  # (3H, H): GRU0's hidden (layer0 output) columns
    whh0: torch.Tensor  # (3H, H)
    bhh0: torch.Tensor  # (3H,)
    wih1: torch.Tensor  # (3H, H)
    bih1: torch.Tensor  # (3H,)
    whh1: torch.Tensor  # (3H, H)
    bhh1: torch.Tensor  # (3H,)
    w_out: torch.Tensor  # (pose_out, H)
    b_out: torch.Tensor  # (pose_out,)


class DecoderBPTT(torch.autograd.Function):
    """The ``normal`` cell over a window of T frames, forward and backward.

    Inputs: the carry's pose (x0 (B, pose_out), root_pos (B, 3), root_rot
    (B, 4)) and hidden states h0, h1 (B, H); the gaze (B, T, 3); the hoisted
    speech/style products pre_l0 (B, T, H) and pre_g0 (B, T, 3H), biases
    included; `Weights`; the pose statistics and dt. Outputs: the
    denormalised outputs p (B, T, pose_out), root_pos (B, T, 3), root_rot
    (B, T, 4), and the last frame's h0, h1."""

    @staticmethod
    def forward(ctx, x0, rp0, rr0, h0, h1, gaze, pre_l0, pre_g0, stats, dt, *weights):
        W = Weights(*weights)
        mean_in, std_in, mean_out, std_out = stats
        ops = step_ops(x0.device)
        B, T, H = pre_l0.shape
        D, Din = mean_out.shape[0], mean_in.shape[0]
        like = dict(dtype=x0.dtype, device=x0.device)
        P = torch.empty((B, T, D), **like)
        RP = torch.empty((B, T, 3), **like)
        RR = torch.empty((B, T, 4), **like)
        pose = torch.empty((T, B, Din), **like)
        act = torch.empty((T, B, H), **like)  # layer0's pre-activation
        hid = torch.empty((T, B, H), **like)
        hs0 = torch.empty((T + 1, B, H), **like)
        hs1 = torch.empty((T + 1, B, H), **like)
        gates0 = torch.empty((T, B, 4 * H), **like)
        gates1 = torch.empty((T, B, 4 * H), **like)
        a0 = torch.empty((B, H), **like)
        ag = torch.empty((B, 3 * H), **like)
        g = torch.empty((B, 3 * H), **like)
        gh0 = torch.empty((B, 3 * H), **like)
        gh1 = torch.empty((B, 3 * H), **like)
        gi1 = torch.empty((B, 3 * H), **like)
        out = torch.empty((B, D), **like)
        hs0[0].copy_(h0)
        hs1[0].copy_(h1)

        def state(t):  # root_pos, root_rot of frame t's input
            return (rp0, rr0) if t == 0 else (RP[:, t - 1], RR[:, t - 1])

        # each product as the plain step makes it (`models.decoder.chunk_step`),
        # so that cuBLAS rounds it the same: the pose columns' two products,
        # F.linear's addmm with the bias, the frame-0 hidden state as given
        ops.pose_fwd(None, mean_out, std_out, x0, rp0, rr0, None, None, None, gaze[:, 0],
                     mean_in, std_in, pose[0], dt)
        for t in range(T):
            h0_t = h0 if t == 0 else hs0[t]
            torch.mm(pose[t], W.w0_pose.t(), out=a0)
            torch.mm(pose[t], W.wg_pose.t(), out=ag)
            torch.addmm(W.bhh0, h0_t, W.whh0.t(), out=gh0)
            torch.addmm(W.bhh1, hs1[t], W.whh1.t(), out=gh1)
            ops.elu_fwd(pre_l0[:, t], a0, act[t], hid[t])
            torch.mm(hid[t], W.w_gh.t(), out=g)
            ops.gru_fwd(pre_g0[:, t], g, ag, gh0, h0_t, hs0[t + 1], gates0[t])
            torch.addmm(W.bih1, hs0[t + 1], W.wih1.t(), out=gi1)
            ops.gru_fwd(gi1, None, None, gh1, hs1[t], hs1[t + 1], gates1[t])
            torch.addmm(W.b_out, hs1[t + 1], W.w_out.t(), out=out)
            rp, rr = state(t)
            last = t + 1 == T
            ops.pose_fwd(out, mean_out, std_out, None, rp, rr, P[:, t], RP[:, t],
                         RR[:, t], None if last else gaze[:, t + 1], mean_in, std_in,
                         None if last else pose[t + 1], dt)
        profiling.count("decoder_bptt.forwards")
        ctx.dt = dt
        ctx.bufs = (pose, act, hid, hs0, hs1, gates0, gates1)
        ctx.save_for_backward(rp0, rr0, gaze, P, RP, RR, mean_in, std_in, std_out, *weights)
        return P, RP, RR, hs0[T].clone(), hs1[T].clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, dP, dRP, dRR, dhT0, dhT1):
        rp0, rr0, gaze, P, RP, RR, mean_in, std_in, std_out, *weights = ctx.saved_tensors
        W = Weights(*weights)
        pose, act, hid, hs0, hs1, gates0, gates1 = ctx.bufs
        ops = step_ops(rp0.device)
        T, B, H = hid.shape
        D = std_out.shape[0]
        like = dict(dtype=rp0.dtype, device=rp0.device)
        dP, dRP, dRR = dP.contiguous(), dRP.contiguous(), dRR.contiguous()
        d_a = torch.empty((T, B, 4 * H), **like)  # [d pre_l0 | d pre_g0] a frame
        dgh0 = torch.empty((T, B, 3 * H), **like)
        dgi1 = torch.empty((T, B, 3 * H), **like)
        dgh1 = torch.empty((T, B, 3 * H), **like)
        dout = torch.empty((T, B, D), **like)
        dgaze = torch.empty((B, T, 3), **like)
        dx0 = torch.empty((B, D), **like)
        dpose = torch.empty((B, pose.shape[-1]), **like)
        dhid = torch.empty((B, H), **like)
        # (pose_in, 4H): the pose's input product is faster on the
        # transposed stack (cuBLAS at B = 32: 23.5 against 30.7 us)
        w_pose_t = torch.cat([W.w0_pose, W.wg_pose]).t().contiguous()
        dh0, dh1 = dhT0.contiguous().clone(), dhT1.contiguous().clone()
        g_rp = torch.zeros((B, 3), **like)
        g_rr = torch.zeros((B, 4), **like)

        def state(t):
            return (rp0, rr0) if t == 0 else (RP[:, t - 1], RR[:, t - 1])

        def boundary(t):
            """Back through the pose op between frames t - 1 and t."""
            rp, rr = state(t)
            inside = t < T
            first = t == 0
            ops.pose_bwd(dpose if inside else None, std_in, gaze[:, t] if inside else None,
                         rp, rr, dgaze[:, t] if inside else None,
                         None if first else dP[:, t - 1],
                         None if first else dRP[:, t - 1],
                         None if first else dRR[:, t - 1],
                         None if first else P[:, t - 1],
                         None if first else state(t - 1)[1], std_out,
                         None if first else dout[t - 1], g_rp, g_rr, dx0 if first else None,
                         ctx.dt)

        need = ctx.needs_input_grad
        # frame 0's pose is the carry's: its gradient only where the carry
        # or the gaze needs one
        first_pose = any(need[i] for i in (0, 1, 2, 5))
        boundary(T)
        for t in reversed(range(T)):
            torch.addmm(dh1, dout[t], W.w_out, out=dh1)
            ops.gru_bwd(dh1, gates1[t], hs1[t], dgi1[t], dgh1[t])
            torch.addmm(dh0, dgi1[t], W.wih1, out=dh0)
            torch.addmm(dh1, dgh1[t], W.whh1, out=dh1)
            ops.gru_bwd(dh0, gates0[t], hs0[t], d_a[t, :, H:], dgh0[t])
            torch.addmm(dh0, dgh0[t], W.whh0, out=dh0)
            torch.mm(d_a[t, :, H:], W.w_gh, out=dhid)
            ops.elu_bwd(dhid, act[t], d_a[t, :, :H])
            if t > 0 or first_pose:
                torch.mm(d_a[t], w_pose_t.t(), out=dpose)
                boundary(t)
        profiling.count("decoder_bptt.backwards")

        rows = T * B

        def wgrad(i, dy, x):
            return torch.mm(dy.reshape(rows, -1).t(), x.reshape(rows, -1)) if need[i] else None

        def bgrad(i, dy):
            return dy.reshape(rows, -1).sum(0) if need[i] else None

        base = 10  # the weights follow the ten other inputs
        d_flat = d_a.view(rows, 4 * H)
        d_pose = torch.mm(d_flat.t(), pose.view(rows, -1)) if need[base] or need[base + 1] else None
        grads_w = (
            d_pose[:H] if need[base] else None, d_pose[H:] if need[base + 1] else None,
            torch.mm(d_flat[:, H:].t(), hid.view(rows, H)) if need[base + 2] else None,
            wgrad(base + 3, dgh0, hs0[:T]), bgrad(base + 4, dgh0),
            wgrad(base + 5, dgi1, hs0[1:]), bgrad(base + 6, dgi1),
            wgrad(base + 7, dgh1, hs1[:T]), bgrad(base + 8, dgh1),
            wgrad(base + 9, dout, hs1[1:]), bgrad(base + 10, dout),
        )
        d_bt = d_a.transpose(0, 1)
        return (dx0 if need[0] else None, g_rp if need[1] else None, g_rr if need[2] else None,
                dh0 if need[3] else None, dh1 if need[4] else None,
                dgaze if need[5] else None, d_bt[..., :H] if need[6] else None,
                d_bt[..., H:] if need[7] else None, None, None, *grads_w)


def rollout_bptt(cell, carry, gaze, pre_l0, pre_g0, anim_input_mean, anim_input_std,
                 anim_output_mean, anim_output_std, dt):
    """The ``normal`` cell's rollout over the window of ``pre_l0`` (B, T, H)
    from ``carry`` (`models.decoder.init_carry`'s) through `DecoderBPTT`,
    differentiable in the carry, the gaze, the hoisted products and the
    cell's parameters -> (new_carry, the 8 trajectories (B, T, ...)), as
    `models.decoder.rollout_chunk` returns them."""
    h, rp0, rr0, *parts = carry
    B, T = pre_l0.shape[:2]
    J = parts[2].shape[1]
    H = cell.gru1.weight_hh.shape[1]
    pose_in = anim_input_mean.shape[-1]
    x0 = torch.cat([p.reshape(B, -1) for p in parts], dim=1)
    w0, wg = cell.layer0.weight, cell.gru0.weight_ih
    weights = Weights(
        w0_pose=w0[:, :pose_in], wg_pose=wg[:, H : H + pose_in], w_gh=wg[:, :H],
        whh0=cell.gru0.weight_hh, bhh0=cell.gru0.bias_hh, wih1=cell.gru1.weight_ih,
        bih1=cell.gru1.bias_ih, whh1=cell.gru1.weight_hh, bhh1=cell.gru1.bias_hh,
        w_out=cell.out.weight, b_out=cell.out.bias)
    stats = tuple(s.contiguous() for s in (anim_input_mean, anim_input_std, anim_output_mean,
                                           anim_output_std))
    P, RP, RR, hT0, hT1 = DecoderBPTT.apply(
        x0, rp0.contiguous(), rr0.contiguous(), h[0], h[1], gaze.contiguous(),
        pre_l0.contiguous(), pre_g0.contiguous(), stats, dt, *weights)
    o = 6
    ys = (RP, RR, P[..., 0:3], P[..., 3:6], P[..., o : o + 3 * J].reshape(B, T, J, 3),
          P[..., o + 3 * J : o + 9 * J].reshape(B, T, J, 2, 3),
          P[..., o + 9 * J : o + 12 * J].reshape(B, T, J, 3),
          P[..., o + 12 * J : o + 15 * J].reshape(B, T, J, 3))
    new_carry = (torch.stack([hT0, hT1]),) + tuple(y[:, -1] for y in ys)
    return new_carry, ys
