"""Device selection for the port."""

from __future__ import annotations

import torch


def require_device(name) -> torch.device:
    """Resolve ``name`` ("cuda", "cuda:1", "cpu" or a torch.device) and
    raise if it names a card this process cannot see: the port never moves
    to the CPU on its own.

    On a card, float32 products must run in full float32: the speech
    encoder's k=31 convolution goes through cuDNN, which uses TF32 by
    default and would then keep only about three decimal digits.
    """
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but no CUDA device is available")
        if device.index is not None and device.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only {torch.cuda.device_count()} CUDA devices exist"
            )
        # float32 matmuls and cuDNN convolutions in full float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return device
