"""The inference decoder step's element-wise math as the four kernels of
csrc/decoder_step.cu, their plain PyTorch versions and their launch count.

`models.decoder.chunk_step`'s step runs, between its cuBLAS products:

    pose_in   the next input from the pose state and the gaze
              (`models.pose.vectorize_input`)
    elu       layer0's activation elu(l0 + pose W0^T), and for ``film`` the
              scale and shift of both hidden layers, elu(x) * gamma + beta
    gates     GRU0's h' from (g0 + hidden Wg_h^T) + pose Wg_pose^T and the
              hidden product (`models.layers.gru_gates`)
    pose_out  the output denormalised and the root integrated
              (`models.pose.devectorize_output`)

`PlainOps` is each kernel's plain version: the step's own expressions,
which the CPU, the differentiable (``plain``) step and any other dtype
take. `CudaOps` launches the kernels on float32 CUDA tensors and raises on
anything they do not take. `step_ops` picks one from what the step can
observe. The kernels round as the plain versions' operators do, so a step
of either gives the same results bit for bit.

Each launch counts one ``decoder_step.launches`` (`utils.profiling`): 4 a
``normal`` step, 5 a ``film`` step, 2 an int8 step (its quantized cell is
plain PyTorch).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...models import layers as L
from ...models import pose as P
from ...utils import profiling
from . import build


class PlainOps:
    """Each kernel's function as the step computes it in PyTorch, on any
    device and float dtype, differentiable."""

    @staticmethod
    def pose_in(rp, rr, rv, rw, lpos, ltxy, lvel, lvrt, gaze, mean_in, std_in):
        return P.vectorize_input(rp, rr, rv, rw, lpos, ltxy, lvel, lvrt, gaze, mean_in, std_in)

    @staticmethod
    def elu(pre, a=None, gamma=None, beta=None):
        """elu(pre (+ a)), then (* gamma + beta)."""
        hid = L.elu(pre if a is None else pre + a)
        return hid if gamma is None else hid * gamma + beta

    @staticmethod
    def gru_gates(s0, s1, s2, gh, h):
        """h' from gi = (s0 + s1) + s2 and gh."""
        return L.gru_gates(s0 + s1 + s2, gh, h)

    @staticmethod
    def pose_out(out, rp, rr, njoints, dt, mean_out, std_out):
        return P.devectorize_output(out, rp, rr, njoints, dt, mean_out, std_out)


@functools.cache
def _library():
    lib = build.load("decoder_step")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.zeggs_ds_pose_in.argtypes = [p, i] * 9 + [p, p, p, i, i, p]
    lib.zeggs_ds_elu.argtypes = [p, i] * 4 + [p, i, i, p]
    lib.zeggs_ds_gru_gates.argtypes = [p, i] * 3 + [p, p, i, p, i, i, p]
    lib.zeggs_ds_pose_out.argtypes = [p] * 4 + [i, p, i] + [p] * 3 + [i, i, f, p]
    for fn in ("pose_in", "elu", "gru_gates", "pose_out"):
        getattr(lib, f"zeggs_ds_{fn}").restype = i
    lib.zeggs_ds_error_string.argtypes = [i]
    lib.zeggs_ds_error_string.restype = ctypes.c_char_p
    return lib


def _check(t, device):
    if t.dtype != torch.float32 or t.device.type != "cuda" or t.device != device:
        raise TypeError(f"the decoder_step kernels take float32 CUDA tensors on one card, not "
                        f"{t.dtype} on {t.device}")


def _packed(t):
    """Whether each (leading-axis) row of ``t`` holds its values packed."""
    packed = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != packed:
            return False
        packed *= size
    return True


def _state(t):
    """A caller's state tensor as the pose kernels take it: itself where its
    rows are packed (a program's buffers, the last step's views), else a
    contiguous copy (an eager rollout may start from any view)."""
    return t if _packed(t) else t.contiguous()


def _rows(t, device, shape):
    """(pointer, row stride) of a tensor of ``shape`` whose rows each hold
    their values packed (any row stride), or (None, 0)."""
    if t is None:
        return None, 0
    _check(t, device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"the decoder_step kernels expected a {tuple(shape)} tensor here, not "
                         f"{tuple(t.shape)}")
    if not _packed(t):
        raise ValueError(f"the decoder_step kernels take rows of packed values, not a "
                         f"{tuple(t.shape)} tensor of strides {t.stride()}")
    return t.data_ptr(), t.stride(0)


def _contiguous(t, device, shape):
    """Pointer of a contiguous tensor of ``shape``."""
    _check(t, device)
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"the decoder_step kernels take a contiguous {tuple(shape)} tensor "
                         f"here, not {tuple(t.shape)} of strides {t.stride()}")
    return t.data_ptr()


def _launch(name, device, *args):
    """Launch csrc/decoder_step.cu's zeggs_ds_<name> on the current stream of
    ``device`` and count it; raises on a CUDA error."""
    lib = _library()
    with torch.cuda.device(device):
        err = getattr(lib, f"zeggs_ds_{name}")(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decoder_step {name} kernel failed: CUDA error {err} "
                           f"({lib.zeggs_ds_error_string(err).decode()})")
    profiling.count("decoder_step.launches")


class CudaOps:
    """The same ops as `PlainOps`, each one launch of a kernel of
    csrc/decoder_step.cu on float32 CUDA tensors, with new contiguous
    outputs. Inputs are (B, ...) with each row's values packed and any row
    stride (a column of a (B, n, ...) tensor, a view of the last step's
    output; the pose state and gaze are copied where they are not);
    ``out`` and ``gh`` contiguous."""

    @staticmethod
    def pose_in(rp, rr, rv, rw, lpos, ltxy, lvel, lvrt, gaze, mean_in, std_in):
        dev = rp.device
        B, J = rp.shape[0], lpos.shape[1]
        D = 6 + 15 * J
        pose = torch.empty((B, D + 3), dtype=torch.float32, device=dev)
        shapes = ((B, 3), (B, 3), (B, J, 3), (B, J, 2, 3), (B, J, 3), (B, J, 3), (B, 3), (B, 4),
                  (B, 3))
        # the copies are held until the launch is enqueued
        state = [_state(t) for t in (rv, rw, lpos, ltxy, lvel, lvrt, rp, rr, gaze)]
        _launch("pose_in", dev, *(x for t, shape in zip(state, shapes)
                                  for x in _rows(t, dev, shape)),
                _contiguous(mean_in, dev, (D + 3,)), _contiguous(std_in, dev, (D + 3,)),
                pose.data_ptr(), B, J)
        return pose

    @staticmethod
    def elu(pre, a=None, gamma=None, beta=None):
        dev = pre.device
        B, H = pre.shape
        if (gamma is None) != (beta is None):
            raise ValueError("the FiLM scale and shift come together")
        hid = torch.empty((B, H), dtype=torch.float32, device=dev)
        _launch("elu", dev, *(x for t in (pre, a, gamma, beta) for x in _rows(t, dev, (B, H))),
                hid.data_ptr(), B, H)
        return hid

    @staticmethod
    def gru_gates(s0, s1, s2, gh, h):
        dev = h.device
        B, H = h.shape
        h_new = torch.empty((B, H), dtype=torch.float32, device=dev)
        _launch("gru_gates", dev, *(x for t in (s0, s1, s2) for x in _rows(t, dev, (B, 3 * H))),
                _contiguous(gh, dev, (B, 3 * H)), *_rows(h, dev, (B, H)), h_new.data_ptr(), B, H)
        return h_new

    @staticmethod
    def pose_out(out, rp, rr, njoints, dt, mean_out, std_out):
        dev = out.device
        B, J, o = out.shape[0], njoints, 6
        D = o + 15 * J
        like = dict(dtype=torch.float32, device=dev)
        p = torch.empty((B, D), **like)
        rp_new, rr_new = torch.empty((B, 3), **like), torch.empty((B, 4), **like)
        rp_in, rr_in = _state(rp), _state(rr)  # held until the launch is enqueued
        _launch("pose_out", dev, _contiguous(out, dev, (B, D)),
                _contiguous(mean_out, dev, (D,)), _contiguous(std_out, dev, (D,)),
                *_rows(rp_in, dev, (B, 3)), *_rows(rr_in, dev, (B, 4)), p.data_ptr(),
                rp_new.data_ptr(), rr_new.data_ptr(), B, D, float(dt))
        return (rp_new, rr_new, p[:, 0:3], p[:, 3:6], p[:, o : o + J * 3].reshape(B, J, 3),
                p[:, o + J * 3 : o + J * 9].reshape(B, J, 2, 3),
                p[:, o + J * 9 : o + J * 12].reshape(B, J, 3),
                p[:, o + J * 12 : o + J * 15].reshape(B, J, 3))


def step_ops(state, plain):
    """The kernels for a float32 CUDA ``state`` tensor of a step that is not
    ``plain``; the plain versions otherwise (the CPU, autograd recording,
    another compute dtype)."""
    if not plain and state.device.type == "cuda" and state.dtype == torch.float32:
        return CudaOps
    return PlainOps
