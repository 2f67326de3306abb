"""audio_key_estimation_torch — PyTorch/CUDA port of the key estimator.

The JAX package `audio_key_estimation_tpu` is the reference; this package
reproduces its serving path (audio -> batched log1p-CQT -> PitchClassNet
-> key name), its dataset preprocessing (audio files -> batched CQT
per group of songs -> feature cache -> labels -> padded batches) and its
training and evaluation (loss, MIREX metrics, Adam, the Trainer,
checkpoints) on PyTorch, with the TPU's Pallas kernels rewritten by hand as CUDA C++
kernels for Hopper (sm_90a). It imports `torch` and never `jax`, and
nothing of the reference package: what it needs from there (the
`Config`, the key-signature map, the CQT constants, the decoders, the
loaders and label builders, the C++ audio library's sources) it carries
as its own copies, pinned to the originals by
tests/test_torch_imports.py. Its entry points run on the CUDA card and
on the CPU only when the caller asks for it (device="cpu").

Layering (bottom -> top), module names mirror the JAX package:
  csrc/       CUDA C++ kernels (nvcc) and their torch.ops.akt operators
              (bindings.cpp), built at first use (ops/_build.py)
  ops/        CQT front-end (plain PyTorch + cqt_cuda kernels A/B),
              equivariant convs, pooling, masked pooling, the fused
              ConvStack layer (convstack_cuda kernel C)
  models/     nn.Modules: PitchClassNet (every variant), the two-scale
              ensemble PitchClassNetMulti (build_model picks the class),
              blocks, channel schedule, JAX variables and Adam state ->
              state_dict and torch.optim state conversion
  native/     the host C++ audio library (WAV, MP3, decode pool, batch
              ingest) and its ctypes binding, built at first use
  data/       audio decode and batch ingest, the MP3 decoder, corpus
              loaders, synthetic corpora, KeyDataset, batch prefetch
  utils/      the key-signature map, label builders, metrics logging,
              the tracer (`span`/`spans`/`totals`, `akx.*` spans at the
              layer boundaries) and `trace(log_dir)`, its Chrome trace
  train/      loss, MIREX metrics, Adam with per-epoch decay,
              checkpoints, the Trainer (data-parallel under torchrun)
  parallel/   the device mesh for sharded serving, the process group
              and the collectives for DDP training
  scrape/     the YouTube corpus scraper (gated live backend)
  config.py   the Config dataclass and its argparse helpers
  predict.py  KeyEstimator serving API
  cli/        train, eval, predict, equivariance and scrape entry
              points, dataset wiring
"""

__version__ = "0.1.0"
