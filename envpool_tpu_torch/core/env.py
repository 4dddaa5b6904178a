"""Batched environment contract for the PyTorch engine.

Counterpart of ``envpool_tpu/core/env.py``.  The JAX env is a pure function
pair written for ONE env and ``vmap``ped; here an env is written
batched-first, over ``[N, ...]`` tensors on one device:

    ``reset_env(draws)                  -> (state, obs_dict)``
    ``step_env(state, action, draws)    -> EnvOut(state, obs, reward, ...)``

Randomness enters as tensors drawn beforehand (``reset_draws(subkey)`` /
``step_draws(subkey)``, from the per-env streams of ``core/rng.py``), so a
test can hand the port exactly the draws the JAX env made.

Config semantics are those of the JAX package (``COMMON_CONFIG`` and
:func:`merge_config` are copied), plus the ``device`` key.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import rng
from .specs import ArraySpec

__all__ = [
    "COMMON_CONFIG",
    "INT32_MAX",
    "EnvOut",
    "TorchEnv",
    "merge_config",
    "tree_where",
]

INT32_MAX = 2**31 - 1

# Reference: common_config in envpool/core/env_spec.h:26-31.  ``num_threads``
# and ``thread_affinity_offset`` are accepted for drop-in compatibility but
# are no-ops: there is no host thread pool — envs run vectorized on device.
COMMON_CONFIG: dict[str, Any] = {
    "num_envs": 1,
    "batch_size": 0,
    "num_threads": 0,
    "max_num_players": 1,
    "thread_affinity_offset": -1,
    "base_path": "envpool_tpu",
    "seed": 42,
    "env_seed": [],
    "gym_reset_return_info": True,
    "max_episode_steps": INT32_MAX,
    # envpool_tpu extension: when True (default) the gym/dm adapters return
    # host numpy arrays (reference-compatible); when False they return
    # device-resident tensors (fast path — no host transfer per step).
    "numpy_output": True,
    # Accepted for config compatibility with envpool_tpu; only None is
    # supported (one device per pool).
    "sharding": None,
    # Directory for one .npz of actions per finished episode
    # (adapters/record.py); "" records nothing.
    "record_dir": "",
    "render_mode": "rgb_array",
    # envpool_tpu_torch: the torch device that holds the pool's state.
    "device": "cuda",
}


def merge_config(default_config: dict[str, Any], **kwargs: Any) -> dict[str, Any]:
    """Merge COMMON_CONFIG ⊕ env defaults ⊕ user kwargs.

    Mirrors ``EnvSpec`` construction (``envpool/core/env_spec.h:70-84``):
    validates ``batch_size <= num_envs`` and resolves ``batch_size == 0`` to
    ``num_envs``.
    """
    config = dict(COMMON_CONFIG)
    config.update(default_config)
    unknown = set(kwargs) - set(config)
    if unknown:
        raise TypeError(f"unknown config keys: {sorted(unknown)}")
    config.update(kwargs)
    num_envs = int(config["num_envs"])
    batch_size = int(config["batch_size"])
    if batch_size > num_envs:
        raise ValueError(
            "It is required that batch_size <= num_envs, got num_envs = "
            f"{num_envs}, batch_size = {batch_size}"
        )
    if batch_size == 0:
        config["batch_size"] = num_envs
    env_seed = config["env_seed"]
    if len(env_seed) not in (0, num_envs):
        raise ValueError(
            "`env_seed` must contain exactly one seed for each env"
        )
    return config


def tree_where(pred: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """Per-leaf ``torch.where`` over nested dicts; ``pred`` is ``[N]``."""
    if isinstance(on_true, dict):
        return {k: tree_where(pred, on_true[k], on_false[k]) for k in on_true}
    p = pred.reshape(pred.shape + (1,) * (on_true.ndim - pred.ndim))
    return torch.where(p, on_true, on_false)


@dataclasses.dataclass
class EnvOut:
    """Result of one batched in-episode transition.

    ``obs`` maps every key of ``state_spec()`` to its new ``[N, ...]`` value.
    ``reward`` is float32; ``terminated`` is the env-specific termination
    (the engine or's in time-limit truncation).  ``discount`` may override
    the default ``1 - done``; ``truncated`` may force truncation.
    """

    state: Any
    obs: dict[str, torch.Tensor]
    reward: torch.Tensor
    terminated: torch.Tensor
    discount: torch.Tensor | None = None
    truncated: torch.Tensor | None = None


class TorchEnv:
    """Base class for batched torch envs.

    Subclasses define ``DEFAULT_CONFIG``, ``state_spec``/``action_spec``,
    the draw functions and the batched ``reset_env``/``step_env``.
    """

    DEFAULT_CONFIG: dict[str, Any] = {}
    reward_threshold: float | None = None

    def __init__(self, config: dict[str, Any]):
        if config.get("sharding") is not None:
            raise NotImplementedError(
                "envpool_tpu_torch runs one pool on one device; "
                "sharding must be None"
            )
        self.config = config
        self.device = torch.device(config["device"])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )

    # -- static specs ------------------------------------------------------

    def state_spec(self) -> dict[str, ArraySpec]:
        """Env-specific state fields: ``obs``/``obs:*`` and ``info:*`` keys."""
        raise NotImplementedError

    def action_spec(self) -> dict[str, ArraySpec]:
        raise NotImplementedError

    # -- random draws ------------------------------------------------------

    def reset_draws(self, sub: torch.Tensor) -> dict[str, torch.Tensor]:
        """The draws one reset consumes, from ``[N, 2]`` subkeys."""
        del sub
        return {}

    def step_draws(self, sub: torch.Tensor) -> dict[str, torch.Tensor]:
        """The draws one step consumes, from ``[N, 2]`` subkeys."""
        del sub
        return {}

    # -- batched dynamics --------------------------------------------------

    def reset_env(self, draws: dict[str, torch.Tensor]):
        """Start fresh episodes for every row: returns (state, obs_dict)."""
        raise NotImplementedError

    def reset_env_from(self, state: Any, draws: dict, full: torch.Tensor):
        """Auto-reset transition that sees the terminal state.

        ``full`` (``[N]`` bool) is True where a full restart is required.
        Most envs ignore ``state`` and start fresh (the default).
        """
        del state, full
        return self.reset_env(draws)

    def step_env(self, state: Any, action: Any, draws: dict) -> EnvOut:
        """Advance every row one step."""
        raise NotImplementedError

    # -- optional rendering (RenderableEnv analog, core/env.h:30-38) -------

    render_size: tuple[int, int] | None = None  # (height, width) or None

    def render_state(self, state: Any) -> torch.Tensor:
        """Rasterization of a batch of env states: ``[N, H, W, 3]`` uint8."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support render"
        )

    # -- helpers -----------------------------------------------------------

    @classmethod
    def from_config(cls, **kwargs: Any) -> "TorchEnv":
        return cls(merge_config(cls.DEFAULT_CONFIG, **kwargs))

    @property
    def max_episode_steps(self) -> int:
        return int(self.config["max_episode_steps"])

    @property
    def num_envs(self) -> int:
        return int(self.config["num_envs"])

    @property
    def max_num_players(self) -> int:
        return int(self.config["max_num_players"])

    def single_action(self, action_tree: Any) -> Any:
        """Unwrap single-key action trees to the bare tensor."""
        spec = self.action_spec()
        if isinstance(action_tree, dict) and set(action_tree) == set(spec):
            if len(spec) == 1:
                return next(iter(action_tree.values()))
        return action_tree

    def seeds(self) -> np.ndarray:
        """Per-env integer seeds following ``Env::ResolveSeed``.

        ``seed + env_id`` by default, or the explicit per-env ``env_seed``
        list (``envpool/core/env.h:101-110``).
        """
        num_envs = self.num_envs
        env_seed = self.config["env_seed"]
        if len(env_seed):
            return np.asarray(env_seed, dtype=np.int64)
        return int(self.config["seed"]) + np.arange(num_envs, dtype=np.int64)

    def keys(self) -> torch.Tensor:
        """``[N, 2]`` per-env random-stream keys on the env's device."""
        return rng.seed_keys(self.seeds(), self.device)
