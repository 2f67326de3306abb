"""Training and evaluation: loss, MIREX metrics, Adam with per-epoch
decay, checkpoints and the Trainer (the JAX package's train/)."""

from .loss import compute_loss  # noqa: F401
from .metrics import all_key_accuracy, mirex_score  # noqa: F401
