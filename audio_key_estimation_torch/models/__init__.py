"""PitchClassNet in PyTorch, its two-scale ensemble, blocks, channel
schedule and weight conversion."""

from .multi_scale import PitchClassNetMulti, build_model  # noqa: F401
from .pitchclassnet import PitchClassNet  # noqa: F401
