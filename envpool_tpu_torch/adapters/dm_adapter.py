"""dm_env adapter.

Counterpart of ``envpool_tpu/adapters/dm_adapter.py`` (reference
``envpool/python/dm_envpool.py:29-103``): ``reset``/``step`` return a
``TimeStep(step_type, observation, reward, discount)`` whose observation
is a ``State`` namedtuple merging obs and info fields.

``dm_env`` is optional here: with it the pool is a ``dm_env.Environment``
and returns ``dm_env.TimeStep``; without it, a namedtuple with the same
four fields, and only the spec methods need the package.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any

from ..core.env_spec import EnvSpec
from . import data as _data
from .base import EnvPoolBase

try:
    import dm_env

    _DmEnvironment: Any = dm_env.Environment
    TimeStep: Any = dm_env.TimeStep
except ImportError:  # the port's core path does not need dm_env
    _DmEnvironment = object
    TimeStep = namedtuple(
        "TimeStep", ["step_type", "reward", "discount", "observation"]
    )


class DMEnvPool(EnvPoolBase, _DmEnvironment):
    """Batched dm_env API over the torch engine."""

    def __init__(self, spec: EnvSpec):
        super().__init__(spec)

    def observation_spec(self) -> tuple:
        if not hasattr(self, "_dm_observation_spec"):
            self._dm_observation_spec = self.spec.observation_spec()
        return self._dm_observation_spec

    def action_spec(self) -> Any:
        if not hasattr(self, "_dm_action_spec"):
            self._dm_action_spec = self.spec.action_spec()
        return self._dm_action_spec

    def _to(self, state: dict[str, Any], reset: bool, return_info: bool):
        obs_keys = [
            k
            for k in state
            if k.startswith("obs") or k.startswith("info:")
        ]
        new_keys = _data.dm_state_keys(obs_keys)
        flat = {nk: state[k] for nk, k in zip(new_keys, obs_keys)}
        nested = _data.to_nested_dict(flat)["State"]
        observation = _data.to_namedtuple("State", nested)
        return TimeStep(
            step_type=state["step_type"],
            observation=observation,
            reward=state["reward"],
            discount=state["discount"],
        )
