"""dm_control suite env family over the port's batched physics.

Counterpart of ``envpool_tpu/envs/mujoco_dmc``: every domain
(``registration.py``).
"""

from .base import DmcEnv
from .tasks import (
    CartpoleEnv,
    CheetahEnv,
    DmcAcrobotEnv,
    DmcReacherEnv,
    HopperEnv,
    PendulumEnv,
    PointMassEnv,
    SwimmerEnv,
    WalkerEnv,
)
from .tasks2 import (
    BallInCupEnv,
    DmcHumanoidEnv,
    FingerEnv,
    FishEnv,
    HumanoidCMUEnv,
    LqrEnv,
)
from .tasks3 import ManipulatorEnv, QuadrupedEnv, StackerEnv
from .tasks4 import DogEnv

__all__ = [
    "BallInCupEnv",
    "CartpoleEnv",
    "CheetahEnv",
    "DmcAcrobotEnv",
    "DmcEnv",
    "DmcHumanoidEnv",
    "DmcReacherEnv",
    "DogEnv",
    "FingerEnv",
    "FishEnv",
    "HopperEnv",
    "HumanoidCMUEnv",
    "LqrEnv",
    "ManipulatorEnv",
    "PendulumEnv",
    "PointMassEnv",
    "QuadrupedEnv",
    "StackerEnv",
    "SwimmerEnv",
    "WalkerEnv",
]
