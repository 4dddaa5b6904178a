"""Atari-class pixel env family (batched arcade cores in PyTorch)."""

from .arcade_env import ArcadeEnv, ArcadeGame
from .pong import PongEnv, PongGame

__all__ = ["ArcadeEnv", "ArcadeGame", "PongEnv", "PongGame"]
