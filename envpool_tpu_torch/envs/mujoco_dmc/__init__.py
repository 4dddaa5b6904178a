"""dm_control suite env family over the port's batched physics.

Counterpart of ``envpool_tpu/envs/mujoco_dmc``: the tasks whose models the
port's physics runs (``registration.py`` lists what is left out).
"""

from .base import DmcEnv
from .tasks import (
    CartpoleEnv,
    CheetahEnv,
    DmcAcrobotEnv,
    DmcReacherEnv,
    HopperEnv,
    PendulumEnv,
    SwimmerEnv,
    WalkerEnv,
)
from .tasks2 import DmcHumanoidEnv, HumanoidCMUEnv

__all__ = [
    "CartpoleEnv",
    "CheetahEnv",
    "DmcAcrobotEnv",
    "DmcEnv",
    "DmcHumanoidEnv",
    "DmcReacherEnv",
    "HopperEnv",
    "HumanoidCMUEnv",
    "PendulumEnv",
    "SwimmerEnv",
    "WalkerEnv",
]
