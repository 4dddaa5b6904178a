"""Classic-control env family, batched in PyTorch.

Counterpart of ``envpool_tpu/envs/classic_control`` (reference behaviour:
``envpool/classic_control/*.h``).
"""

from .acrobot import AcrobotEnv
from .cartpole import CartPoleEnv
from .mountain_car import MountainCarContinuousEnv, MountainCarEnv
from .pendulum import PendulumEnv

__all__ = [
    "AcrobotEnv",
    "CartPoleEnv",
    "MountainCarContinuousEnv",
    "MountainCarEnv",
    "PendulumEnv",
]
