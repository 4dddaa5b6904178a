"""Atari-class pixel env family (batched arcade cores in PyTorch)."""

from .arcade_env import ArcadeEnv, ArcadeGame
from .machine_env import Machine2600Env, Machine2600Game
from .pong import PongEnv, PongGame

__all__ = [
    "ArcadeEnv",
    "ArcadeGame",
    "Machine2600Env",
    "Machine2600Game",
    "PongEnv",
    "PongGame",
]
