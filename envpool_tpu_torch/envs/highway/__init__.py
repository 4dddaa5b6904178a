"""Highway env family (15 ids), batched in PyTorch.

Counterpart of ``envpool_tpu/envs/highway`` (reference surface:
``envpool/highway``): the straight multi-lane highway (``straight.py``),
the lane-network scenarios on a static table of lanes (``network.py``,
``net_scenarios.py``, ``net_tasks.py``) and the goal-conditioned parking
lot and lane keeping (``scenarios.py``).  Every env is written for a
batch of envs, ``[N, V]`` over V vehicles and ``[N, V, V]`` over vehicle
pairs.
"""

from .net_tasks import (
    ExitEnv,
    IntersectionContinuousEnv,
    IntersectionEnv,
    IntersectionMultiAgentEnv,
    MergeEnv,
    RacetrackEnv,
    RacetrackLargeEnv,
    RacetrackOvalEnv,
    RoundaboutEnv,
    TwoWayEnv,
    UTurnEnv,
)
from .scenarios import LaneKeepingEnv, ParkingEnv
from .straight import HighwayEnv

__all__ = [
    "ExitEnv",
    "HighwayEnv",
    "IntersectionContinuousEnv",
    "IntersectionEnv",
    "IntersectionMultiAgentEnv",
    "LaneKeepingEnv",
    "MergeEnv",
    "ParkingEnv",
    "RacetrackEnv",
    "RacetrackLargeEnv",
    "RacetrackOvalEnv",
    "RoundaboutEnv",
    "TwoWayEnv",
    "UTurnEnv",
]
