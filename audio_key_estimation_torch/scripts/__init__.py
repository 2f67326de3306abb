"""The port's probe and experiment entry points, one per TPU probe script
of the JAX package's `scripts/` (same module names, same environment
variables); run each on a CUDA card as
`python -m audio_key_estimation_torch.scripts.<name>`."""
