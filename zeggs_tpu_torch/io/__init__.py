"""Host IO. BVH, WAV and the native .npz checkpoint format are the JAX
package's own numpy-only modules, shared so that both packages read and
write the same files; `weights` converts checkpoints to PyTorch layout."""

from zeggs_tpu.io import bvh, checkpoint, wav  # noqa: F401  (numpy only, no jax)
