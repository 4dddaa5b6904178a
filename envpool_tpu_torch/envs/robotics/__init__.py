"""Gymnasium-Robotics env family (157 ids), batched in PyTorch.

Counterpart of ``envpool_tpu/envs/robotics`` (reference surface:
``envpool/mujoco/robotics/``): Fetch, HandReach and HandManipulate,
AdroitHand, PointMaze and FrankaKitchen.  Observations are goal-env dicts
``{observation, achieved_goal, desired_goal}`` with success and distance
infos; every env is written for a batch of envs.
"""

from .adroit import AdroitEnv
from .fetch import FetchEnv
from .hand import HandManipulateEnv, HandReachEnv
from .kitchen import FrankaKitchenEnv
from .point_maze import PointMazeEnv

__all__ = [
    "AdroitEnv",
    "FetchEnv",
    "FrankaKitchenEnv",
    "HandManipulateEnv",
    "HandReachEnv",
    "PointMazeEnv",
]
