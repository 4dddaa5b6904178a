"""Typed public surface (``envpool/python/protocol.py:36-417`` analog)."""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import numpy as np

from .specs import ArraySpec

__all__ = ["ArraySpec", "EnvPool", "EnvSpec", "DMEnvPool", "GymnasiumEnvPool"]


@runtime_checkable
class EnvSpec(Protocol):
    """Spec surface of an instantiated env + config."""

    @property
    def config(self) -> Any: ...

    @property
    def state_array_spec(self) -> dict[str, ArraySpec]: ...

    @property
    def action_array_spec(self) -> dict[str, ArraySpec]: ...

    @property
    def reward_threshold(self) -> float | None: ...


@runtime_checkable
class EnvPool(Protocol):
    """Batched pool interface (both API flavors)."""

    all_env_ids: np.ndarray
    num_envs: int
    batch_size: int

    def send(
        self, action: Any, env_id: np.ndarray | None = None
    ) -> None: ...

    def recv(self) -> Any: ...

    def step(
        self, action: Any, env_id: np.ndarray | None = None
    ) -> Any: ...

    def reset(self, env_id: np.ndarray | None = None) -> Any: ...

    def async_reset(self) -> None: ...


class DMEnvPool(EnvPool, Protocol):
    def observation_spec(self) -> Any: ...

    def action_spec(self) -> Any: ...


class GymnasiumEnvPool(EnvPool, Protocol):
    @property
    def observation_space(self) -> Any: ...

    @property
    def action_space(self) -> Any: ...
