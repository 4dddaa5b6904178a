"""EnvSpec: config + full state/action spec surface for one pool.

A copy of ``envpool_tpu/core/env_spec.py`` over the port's env base.

The analog of the reference's pybind ``PyEnvSpec`` + Python ``EnvSpecMixin``
(``envpool/core/env_spec.h:48-85``, ``envpool/python/env_spec.py:34-222``):
merges the engine-level common state/action fields with the env family's
fields, and converts them to Gymnasium spaces and dm_env specs.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Any

import numpy as np

from ..adapters import data as _data
from .env import TorchEnv
from .specs import ArraySpec

__all__ = ["EnvSpec", "common_state_spec", "common_action_spec"]


def common_state_spec() -> dict[str, ArraySpec]:
    """Engine-populated state fields (``envpool/core/env_spec.h:37-43``)."""
    return {
        "info:env_id": ArraySpec(np.int32),
        "info:players.env_id": ArraySpec(np.int32, (-1,)),
        "elapsed_step": ArraySpec(np.int32),
        "done": ArraySpec(np.bool_),
        "reward": ArraySpec(np.float32, (-1,)),
        "discount": ArraySpec(np.float32, (-1,), 0.0, 1.0),
        "step_type": ArraySpec(np.int32),
        "trunc": ArraySpec(np.bool_),
    }


def common_action_spec() -> dict[str, ArraySpec]:
    """Engine-level action fields (``envpool/core/env_spec.h:34-36``)."""
    return {
        "env_id": ArraySpec(np.int32),
        "players.env_id": ArraySpec(np.int32, (-1,)),
    }


class EnvSpec:
    """Spec surface of an instantiated env family + config."""

    def __init__(self, env: TorchEnv):
        self._env = env
        self._state_spec = {**common_state_spec(), **env.state_spec()}
        self._action_spec = {**common_action_spec(), **env.action_spec()}
        self._state_keys = list(self._state_spec)
        self._action_keys = list(self._action_spec)

    @property
    def env(self) -> TorchEnv:
        return self._env

    @property
    def config(self):
        """Config as a namedtuple, like the reference's ``spec.config``."""
        cfg = self._env.config
        fields = [_data._identifier(k) for k in cfg]
        return namedtuple("Config", fields)(*cfg.values())

    @property
    def reward_threshold(self) -> float | None:
        return self._env.reward_threshold

    # -- raw array specs ---------------------------------------------------

    @property
    def state_array_spec(self) -> dict[str, ArraySpec]:
        return dict(self._state_spec)

    @property
    def action_array_spec(self) -> dict[str, ArraySpec]:
        """Env-side action spec (engine fields excluded, as in the mixin)."""
        return {
            k: v
            for k, v in self._action_spec.items()
            if k not in ("env_id", "players.env_id")
        }

    # -- dm_env ------------------------------------------------------------

    def observation_spec(self) -> tuple:
        """Nested namedtuple of dm specs, obs+info merged under ``State``.

        Mirrors ``envpool/python/env_spec.py:74-89``.
        """
        keys, specs = [], []
        for k, v in self._state_spec.items():
            if k.startswith("info:") or k.startswith("obs"):
                keys.append(k)
                specs.append(v)
        new_keys = _data.dm_state_keys(keys)
        flat = {
            nk: _data.dm_spec_transform(nk.split(".")[-1], spec, "obs")
            for nk, spec in zip(new_keys, specs)
        }
        nested = _data.to_nested_dict(flat)
        return _data.to_namedtuple("State", nested).State

    def action_spec(self):
        """dm action spec; single-key specs collapse to the bare spec.

        Mirrors the 3-key collapse of ``envpool/python/env_spec.py:91-116``
        (env_id / players.env_id are engine-side and hidden).
        """
        specs = self.action_array_spec
        if len(specs) == 1:
            k, v = next(iter(specs.items()))
            return _data.dm_spec_transform(k, v, "act")
        flat = {
            k.replace(":", "."): _data.dm_spec_transform(
                k.split(":")[-1], v, "act"
            )
            for k, v in specs.items()
        }
        nested = _data.to_nested_dict(flat)
        return _data.to_namedtuple("Action", nested)

    # -- gymnasium ---------------------------------------------------------

    def _gym_obs_space(self) -> Any:
        import gymnasium

        obs_keys = {
            k: v for k, v in self._state_spec.items() if k.startswith("obs")
        }
        if len(obs_keys) == 1 and "obs" in obs_keys:
            return _data.gym_spec_transform("obs", obs_keys["obs"], "obs")
        flat = {
            k.replace("obs:", "").replace(":", "."): _data.gym_spec_transform(
                k.split(":")[-1], v, "obs"
            )
            for k, v in obs_keys.items()
        }
        return _data.to_gym_dict_space(_data.to_nested_dict(flat))

    def _gym_action_space(self) -> Any:
        import gymnasium

        specs = self.action_array_spec
        if len(specs) == 1:
            k, v = next(iter(specs.items()))
            return _data.gym_spec_transform(k, v, "act")
        flat = {
            k.replace(":", "."): _data.gym_spec_transform(
                k.split(":")[-1], v, "act"
            )
            for k, v in specs.items()
        }
        return _data.to_gym_dict_space(_data.to_nested_dict(flat))

    @property
    def observation_space(self):
        return self._gym_obs_space()

    @property
    def action_space(self):
        return self._gym_action_space()

    @property
    def gymnasium_observation_space(self):
        return self._gym_obs_space()

    @property
    def gymnasium_action_space(self):
        return self._gym_action_space()
