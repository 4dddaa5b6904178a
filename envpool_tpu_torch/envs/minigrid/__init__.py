"""MiniGrid and BabyAI env families (177 ids), batched in PyTorch.

Counterpart of ``envpool_tpu/envs/minigrid``: int8 gridworlds with
MiniGrid's encodings, the 7x7 egocentric view with its shadows, and the
BabyAI level suite on room grids with descriptor missions.
"""

from .babyai import BabyAIGoToEnv, BabyAILocalEnv
from .minigrid_env import MiniGridEnv
from .roomgrid import (
    ActionObjDoorEnv,
    FindObjEnv,
    GoToMazeEnv,
    GoToObjDoorEnv,
    GoToSeqEnv,
    KeyCorridorEnv,
    LockedRoomEnv,
    MultiRoomEnv,
    ObstructedMazeEnv,
    OneRoomEnv,
    OpenDoorEnv,
    OpenMazeEnv,
    OpenTwoDoorsEnv,
    PickupAboveEnv,
    PickupEnv,
    PlaygroundEnv,
    PutNextEnv,
    RoomGridEnv,
    SynthEnv,
    UnlockRGEnv,
)
from .tasks2 import (
    DynamicObstaclesEnv,
    FetchEnv,
    GoToEnv,
    MemoryEnv,
    RedBlueDoorsEnv,
    UnlockEnv,
)
from .wfc import WFCEnv

__all__ = [
    "ActionObjDoorEnv",
    "BabyAIGoToEnv",
    "BabyAILocalEnv",
    "DynamicObstaclesEnv",
    "FetchEnv",
    "FindObjEnv",
    "GoToEnv",
    "GoToMazeEnv",
    "GoToObjDoorEnv",
    "GoToSeqEnv",
    "KeyCorridorEnv",
    "LockedRoomEnv",
    "MemoryEnv",
    "MiniGridEnv",
    "MultiRoomEnv",
    "ObstructedMazeEnv",
    "OneRoomEnv",
    "OpenDoorEnv",
    "OpenMazeEnv",
    "OpenTwoDoorsEnv",
    "PickupAboveEnv",
    "PickupEnv",
    "PlaygroundEnv",
    "PutNextEnv",
    "RedBlueDoorsEnv",
    "RoomGridEnv",
    "SynthEnv",
    "UnlockEnv",
    "UnlockRGEnv",
    "WFCEnv",
]
