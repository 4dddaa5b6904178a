"""Gymnasium vector-env adapter.

Counterpart of ``envpool_tpu/adapters/gymnasium_adapter.py`` (reference
``envpool/python/gymnasium_envpool.py:76-239``): batched ``reset() -> (obs,
info)`` and ``step() -> (obs, reward, terminated, truncated, info)`` with
``terminated = done & ~trunc``, ``options={"reset_mask"}`` partial reset,
and spaces derived from the EnvSpec.

``gymnasium`` is optional here: without it the pool still resets and
steps (it is then a plain object, not a ``gymnasium.Env``), and only the
space properties need the package.
"""

from __future__ import annotations

import warnings
from typing import Any

import numpy as np

from ..core.env_spec import EnvSpec
from . import data as _data
from .base import EnvPoolBase

try:
    import gymnasium

    _GymEnv: Any = gymnasium.Env
except ImportError:  # the port's core path does not need gymnasium
    gymnasium = None
    _GymEnv = object

try:
    from gymnasium.vector.vector_env import AutoresetMode as _AutoresetMode

    _AUTORESET_MODE: Any = _AutoresetMode.NEXT_STEP
except (AttributeError, ImportError):  # pragma: no cover
    _AUTORESET_MODE = None


def _env_ids_from_reset_options(
    options: dict[str, Any] | None, num_envs: int
) -> np.ndarray | None:
    if options is None:
        return None
    unknown = set(options) - {"reset_mask"}
    if unknown:
        raise ValueError(
            "Unsupported Gymnasium reset options for EnvPool: "
            f"{sorted(unknown)}"
        )
    reset_mask = options.get("reset_mask")
    if reset_mask is None:
        return None
    reset_mask = np.asarray(reset_mask, dtype=np.bool_)
    if reset_mask.shape != (num_envs,):
        raise ValueError(
            f"reset_mask must have shape ({num_envs},), got {reset_mask.shape}"
        )
    if not np.any(reset_mask):
        raise ValueError("reset_mask must select at least one environment.")
    return np.flatnonzero(reset_mask).astype(np.int32)


class GymnasiumEnvPool(EnvPoolBase, _GymEnv):
    """Batched Gymnasium API over the torch engine."""

    metadata = (
        {"render_modes": ["rgb_array", "human"], "autoreset_mode": _AUTORESET_MODE}
        if _AUTORESET_MODE is not None
        else {"render_modes": ["rgb_array", "human"]}
    )

    def __init__(self, spec: EnvSpec):
        super().__init__(spec)
        obs_keys = [k for k in self._state_keys if k.startswith("obs")]
        # A single "obs" key is a Box space, anything else a Dict space
        # (EnvSpec._gym_obs_space).
        self._single_obs = obs_keys == ["obs"]

    # -- spaces ------------------------------------------------------------

    @property
    def observation_space(self):
        if not hasattr(self, "_gym_observation_space"):
            self._gym_observation_space = self.spec.gymnasium_observation_space
        return self._gym_observation_space

    @property
    def action_space(self):
        if not hasattr(self, "_gym_action_space"):
            self._gym_action_space = self.spec.gymnasium_action_space
        return self._gym_action_space

    @property
    def single_observation_space(self):
        return self.observation_space

    @property
    def single_action_space(self):
        return self.action_space

    @property
    def is_vector_env(self) -> bool:
        return True

    @property
    def render_mode(self) -> str | None:
        return self.config.get("render_mode", "rgb_array")

    # -- gymnasium reset signature -----------------------------------------

    def reset(
        self,
        env_id: np.ndarray | None = None,
        *,
        seed: int | list[int] | None = None,
        options: dict[str, Any] | None = None,
    ) -> Any:
        if seed is not None:
            warnings.warn(
                "EnvPool seeds are fixed when the environment is created. "
                "reset(seed=...) is ignored; pass seed to make instead.",
                stacklevel=2,
            )
        option_env_id = _env_ids_from_reset_options(options, self.num_envs)
        if env_id is not None and option_env_id is not None:
            raise ValueError(
                "Pass either env_id or options['reset_mask'], not both."
            )
        if option_env_id is not None:
            env_id = option_env_id
        return super().reset(env_id)

    # -- output conversion (``_to_gymnasium``) -----------------------------

    def _to(self, state: dict[str, Any], reset: bool, return_info: bool):
        nested = _data.to_nested_dict(
            {k.replace(":", "."): v for k, v in state.items()}
        )
        info = nested.get("info", {})
        info["elapsed_step"] = nested["elapsed_step"]
        obs = nested["obs"]
        if self._single_obs:
            while isinstance(obs, dict) and len(obs) == 1:
                obs = next(iter(obs.values()))
        if reset:
            if return_info:
                return obs, info
            return obs
        # Works on numpy arrays and torch tensors alike (the functional
        # handle calls this on device tensors).
        done = nested["done"]
        trunc = nested["trunc"]
        terminated = done & ~trunc
        return obs, nested["reward"], terminated, trunc, info
