"""audio_key_estimation_torch — PyTorch/CUDA port of the key estimator.

The JAX package `audio_key_estimation_tpu` is the reference; this package
reproduces its serving path (PCM16 WAV -> batched log1p-CQT ->
PitchClassNet -> key name) on PyTorch, with the TPU's Pallas kernels
rewritten by hand as CUDA C++ kernels for Hopper (sm_90a). It imports
`torch` and never `jax`, and nothing of the reference package: what it
needs from there (the `Config`, the key-signature map, the CQT constants,
the PCM16 reader) it carries as its own copies, pinned to the originals
by tests/test_torch_imports.py. Its entry points serve on the CUDA card
and run on the CPU only when the caller asks for it (device="cpu").

Layering (bottom -> top), module names mirror the JAX package:
  csrc/       CUDA C++ kernels (nvcc) and their torch.ops.akt operators
              (bindings.cpp), built at first use (ops/_build.py)
  ops/        CQT front-end (plain PyTorch + cqt_cuda kernels A/B),
              equivariant convs, pooling, masked pooling, the fused
              ConvStack layer (convstack_cuda kernel C)
  models/     nn.Modules: PitchClassNet (default variant), blocks, channel
              schedule, JAX-variables -> state_dict conversion
  data/       PCM16 WAV decode and batch packing
  utils/      the key-signature map
  config.py   the Config dataclass and its argparse helpers
  predict.py  KeyEstimator serving API
  cli/        predict entry point
"""

__version__ = "0.1.0"
