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
  data/         featurizers, the corpus pipeline, the windowed dataset and
                the device-resident corpus
  models/       speech encoder, style encoders (attn, gru; VAE), decoder
                (normal and FiLM cells)
  train/        the 18-term loss, RAdam and the single-card trainer
  io/           the JAX package's numpy host IO, and the weight bridge
  infer/        GesturePipeline, generate_gesture, batches, streaming
  serve/        the HTTP daemon
  utils/        BVH writing, metric writers, console tables
  cli/          the generate, serve, pipeline and train entry points
"""

__version__ = "0.1.0"
