"""Quaternion, rot6d, FK and mel math on torch tensors; `kernels` holds the
hand-written CUDA kernels and their plain PyTorch versions."""
