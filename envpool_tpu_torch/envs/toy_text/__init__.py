"""Toy-text env family, batched in PyTorch.

Counterpart of ``envpool_tpu/envs/toy_text`` (reference behaviour:
``envpool/toy_text/*.h``).
"""

from .blackjack import BlackjackEnv
from .catch import CatchEnv
from .cliffwalking import CliffWalkingEnv
from .frozen_lake import FrozenLakeEnv
from .nchain import NChainEnv
from .taxi import TaxiEnv

__all__ = [
    "BlackjackEnv",
    "CatchEnv",
    "CliffWalkingEnv",
    "FrozenLakeEnv",
    "NChainEnv",
    "TaxiEnv",
]
