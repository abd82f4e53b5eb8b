"""TF32, the precision below float32, emulated for the control: every
product's operands (linear layers, matrix products, convolutions, einsums)
rounded to TF32's 10-bit mantissa, the sums kept in float32, as the tensor
cores compute a TF32 product. Emulated rather than switched on in cuBLAS,
which takes TF32 only for the shapes its heuristics choose (not a product
of one row), so that the control is in TF32 whatever the shapes."""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

_PRODUCTS = {"linear", "conv1d", "matmul", "__matmul__", "__rmatmul__", "einsum", "mm", "bmm",
             "addmm"}


def to_tf32(x):
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits);
    the gradient passes straight through."""
    if not torch.is_tensor(x) or x.dtype != torch.float32:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach() if x.requires_grad else rounded


class TF32(TorchFunctionMode):
    """Within the mode, products take TF32 operands."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", None) in _PRODUCTS:
            args = tuple(to_tf32(a) if torch.is_tensor(a) else
                         [to_tf32(t) for t in a] if isinstance(a, (list, tuple)) else a
                         for a in args)
            kwargs = {k: to_tf32(v) for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def precision(tf32):
    """float32 products with TF32 off, or with ``tf32`` TF32 products: the
    mode above, and cuBLAS's and cuDNN's TF32 switched on."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        with TF32() if tf32 else contextlib.nullcontext():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
