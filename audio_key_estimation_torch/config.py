"""The shared configuration: the port reuses the JAX package's JAX-free
`Config` (and its argparse helpers) unchanged, so config.json files and
command-line flags stay interchangeable between the two packages."""

from audio_key_estimation_tpu.config import (  # noqa: F401
    Config, add_config_args, config_from_args)
