"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. A wrapper launches its kernel on CUDA tensors and takes the plain
version only for CPU tensors; each launch counts one ``<kernel>.launches``
(`utils.profiling`, names from `build.KERNELS`)."""
