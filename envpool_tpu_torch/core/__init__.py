"""Core contracts: specs, batched env protocol, engine, registry."""

from .engine import Engine, PoolState
from .env import EnvOut, TorchEnv, merge_config
from .env_spec import EnvSpec
from .specs import ArraySpec

__all__ = [
    "ArraySpec",
    "Engine",
    "EnvOut",
    "EnvSpec",
    "PoolState",
    "TorchEnv",
    "merge_config",
]
