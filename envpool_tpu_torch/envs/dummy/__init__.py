"""Dummy env family (the engine's test fixture), batched in PyTorch.

Counterpart of ``envpool_tpu/envs/dummy``.
"""

from .dummy_env import DummyEnv

__all__ = ["DummyEnv"]
