"""Host IO: the port's own copies of the JAX package's numpy-only BVH, WAV
and native .npz checkpoint modules (both packages read and write the same
files); `weights` converts checkpoints to PyTorch layout."""

from . import bvh, checkpoint, wav  # noqa: F401
