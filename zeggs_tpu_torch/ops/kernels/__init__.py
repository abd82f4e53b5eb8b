"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version and its launch count. A wrapper launches its kernel on CUDA
tensors and takes the plain version only for CPU tensors."""
