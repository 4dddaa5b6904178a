"""Composable batched env wrappers."""

from .transforms import (
    FrameStack,
    NormalizeObs,
    RewardClip,
    TransformObservation,
    TransformReward,
    Wrapper,
)

__all__ = [
    "FrameStack",
    "NormalizeObs",
    "RewardClip",
    "TransformObservation",
    "TransformReward",
    "Wrapper",
]
