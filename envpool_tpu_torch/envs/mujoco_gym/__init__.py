"""Gym-MuJoCo env family over the port's batched physics.

Counterpart of ``envpool_tpu/envs/mujoco_gym``: every task of it.
"""

from .base import MujocoGymEnv
from .humanoid import HumanoidEnv, HumanoidStandupEnv
from .tasks import (
    AntEnv,
    HalfCheetahEnv,
    HopperEnv,
    InvertedDoublePendulumEnv,
    InvertedPendulumEnv,
    PusherEnv,
    ReacherEnv,
    SwimmerEnv,
    Walker2dEnv,
)

__all__ = [
    "AntEnv",
    "HalfCheetahEnv",
    "HopperEnv",
    "HumanoidEnv",
    "HumanoidStandupEnv",
    "InvertedDoublePendulumEnv",
    "InvertedPendulumEnv",
    "MujocoGymEnv",
    "PusherEnv",
    "ReacherEnv",
    "SwimmerEnv",
    "Walker2dEnv",
]
