"""PitchClassNet in PyTorch, its blocks, channel schedule and weight
conversion."""

from .pitchclassnet import PitchClassNet  # noqa: F401
