"""ZEGGS on PyTorch and CUDA: the speech-to-gesture system of `zeggs_tpu`,
ported to an NVIDIA H100.

The JAX package `zeggs_tpu` stays the reference; this package keeps its
layout and names so that each counterpart is easy to find, and it never
imports jax. Public functions keep the reference's layouts: (B, T, C)
sequences and (w, x, y, z) quaternions.

Layout:
  device.py     device selection and the float32 matmul/conv rules
  config.py     options.json / data_pipeline_conf.json / data_definition.json
  ops/          quaternion, rot6d, FK and mel math; ops/kernels: CUDA kernels
  csrc/         CUDA C++ sources of the kernels (built with nvcc at first use)
  data/         per-clip animation and audio featurizers
  models/       speech encoder, attention style encoder (VAE), decoder
  io/           the JAX package's numpy host IO, and the weight bridge
  infer/        GesturePipeline and generate_gesture
  cli/          the generate entry point
"""

__version__ = "0.1.0"
