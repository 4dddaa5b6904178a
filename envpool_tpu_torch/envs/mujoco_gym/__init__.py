"""Gym-MuJoCo env family over the port's batched physics.

Counterpart of ``envpool_tpu/envs/mujoco_gym``; HalfCheetah is ported.
"""

from .base import MujocoGymEnv
from .tasks import HalfCheetahEnv

__all__ = ["HalfCheetahEnv", "MujocoGymEnv"]
