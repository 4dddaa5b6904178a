"""Stateful pool wrapper: the analog of ``EnvPoolMixin``, over torch state.

Counterpart of ``envpool_tpu/adapters/base.py``: batched ``step/reset/
send/recv/async_reset``, action normalization (dict or bare array,
optional ``env_id`` routing), and the sync/async split.  With
``batch_size < num_envs`` the pool runs partial steps (gather, step,
scatter over the addressed rows).  CUDA work is queued asynchronously, so
``send`` returns once the step is enqueued and ``recv`` waits for the
oldest one when it copies to numpy.

Not ported yet: ``render``, ``save_state`` and ``load_state`` raise
``NotImplementedError``.
"""

from __future__ import annotations

from collections import deque
from typing import Any

import numpy as np
import torch

from ..core.engine import Engine, TimeStepDict
from ..core.env import TorchEnv
from ..core.env_spec import EnvSpec

__all__ = ["EnvPoolBase"]


class EnvPoolBase:
    """Holds the device-resident PoolState and drives the Engine."""

    def __init__(self, spec: EnvSpec):
        self.spec = spec
        self._env: TorchEnv = spec.env
        self._engine = Engine(self._env)
        self._device = self._env.device
        self._state = self._engine.init()
        self._recv_queue: deque = deque()
        self.num_envs = self._env.num_envs
        self.batch_size = int(self._env.config["batch_size"])
        self.all_env_ids = np.arange(self.num_envs, dtype=np.int32)
        self._numpy_output = bool(self._env.config.get("numpy_output", True))
        self._action_spec = self._env.action_spec()
        self._action_keys = list(self._action_spec.keys())
        self._state_keys = list(spec.state_array_spec.keys())

    # -- properties mirroring EnvPoolMixin ---------------------------------

    @property
    def is_async(self) -> bool:
        return self.batch_size < self.num_envs

    @property
    def config(self) -> dict[str, Any]:
        return dict(self._env.config)

    def __len__(self) -> int:
        return self.num_envs

    def __repr__(self) -> str:
        cfg = ", ".join(f"{k}={v!r}" for k, v in self.config.items())
        return f"{self.__class__.__name__}({cfg})"

    def __str__(self) -> str:
        return self.__repr__()

    # -- action plumbing ---------------------------------------------------

    def _tensor(self, value: Any, dtype: torch.dtype) -> torch.Tensor:
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value))
        return value.to(device=self._device, dtype=dtype)

    def _check_action(
        self, tree: dict[str, torch.Tensor], env_id: torch.Tensor | None
    ) -> None:
        """One-time shape validation (``envpool.py:151-172``)."""
        if getattr(self, "_action_checked", False):
            return
        self._action_checked = True
        batch = self.num_envs if env_id is None else int(env_id.shape[0])
        mnp = self._env.max_num_players
        for key, spec in self._action_spec.items():
            arr = tree[key]
            expect = (batch, *spec.static_shape(mnp))
            if tuple(arr.shape) != expect:
                raise ValueError(
                    f"action[{key!r}] shape {tuple(arr.shape)} != expected "
                    f"{expect} (num rows must match "
                    f"{'env_id' if env_id is not None else 'num_envs'})"
                )

    def _from(
        self,
        action: dict[str, Any] | np.ndarray | torch.Tensor,
        env_id: np.ndarray | None,
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor | None]:
        """Normalize user action into a batched action tree + env_id rows.

        Accepts a bare array for single-key action specs or a flat dict,
        mirroring ``envpool.py:174-208``.
        """
        if isinstance(action, dict):
            flat = dict(action)
            env_id_from_dict = flat.pop("env_id", None)
            flat.pop("players.env_id", None)
            if env_id is None and env_id_from_dict is not None:
                env_id = env_id_from_dict
            tree = {}
            for k in self._action_keys:
                if k not in flat:
                    raise KeyError(f"missing action key {k!r}")
                tree[k] = self._tensor(flat[k], self._action_spec[k].torch_dtype)
        else:
            if len(self._action_keys) != 1:
                raise ValueError(
                    "bare-array action requires a single-key action spec; "
                    f"this env expects {self._action_keys}"
                )
            key = self._action_keys[0]
            tree = {key: self._tensor(action, self._action_spec[key].torch_dtype)}
        if env_id is not None:
            env_id = self._tensor(env_id, torch.int64)
        return tree, env_id

    # -- send / recv -------------------------------------------------------

    def send(
        self,
        action: dict[str, Any] | np.ndarray | torch.Tensor,
        env_id: np.ndarray | None = None,
    ) -> None:
        """Enqueue one (partial) step; non-blocking on the card."""
        tree, env_id = self._from(action, env_id)
        self._check_action(tree, env_id)
        if env_id is None and not self.is_async:
            self._state, ts = self._engine.step(self._state, tree)
        else:
            if env_id is None:
                env_id = self._tensor(self.all_env_ids, torch.int64)
            self._state, ts = self._engine.step_partial(
                self._state, tree, env_id
            )
        self._recv_queue.append(ts)

    def recv(self, reset: bool = False, return_info: bool = True) -> Any:
        """Return the oldest dispatched batch."""
        if not self._recv_queue:
            raise RuntimeError(
                "recv() called with no pending batch — call send() or "
                "async_reset() first (reference semantics: every recv is "
                "paired with a prior send)."
            )
        ts = self._recv_queue.popleft()
        return self._to(self._materialize(ts), reset, return_info)

    def async_reset(self) -> None:
        """Reset all envs, delivering results in ``batch_size`` chunks."""
        for start in range(0, self.num_envs, self.batch_size):
            ids = self.all_env_ids[start : start + self.batch_size]
            self._state, ts = self._reset_rows(self._tensor(ids, torch.int64))
            self._recv_queue.append(ts)

    # -- sync step / reset -------------------------------------------------

    def step(
        self,
        action: dict[str, Any] | np.ndarray | torch.Tensor,
        env_id: np.ndarray | None = None,
    ) -> Any:
        self.send(action, env_id)
        return self.recv(reset=False, return_info=True)

    def reset(self, env_id: np.ndarray | None = None) -> Any:
        if env_id is None:
            env_id = self.all_env_ids
        self._state, ts = self._reset_rows(self._tensor(env_id, torch.int64))
        return self._to(
            self._materialize(ts),
            reset=True,
            return_info=bool(self.config.get("gym_reset_return_info", True)),
        )

    def _reset_rows(self, env_id: torch.Tensor):
        if int(env_id.shape[0]) < self.num_envs:
            # Partial reset: only run the reset over the addressed rows.
            return self._engine.reset_partial(self._state, env_id)
        mask = torch.zeros(self.num_envs, dtype=torch.bool, device=self._device)
        mask[env_id] = True
        state, ts = self._engine.reset(self._state, mask)
        ts = {k: v.index_select(0, env_id) for k, v in ts.items()}
        return state, ts

    # -- output ------------------------------------------------------------

    def _materialize(self, ts: TimeStepDict) -> dict[str, Any]:
        if self._numpy_output:
            return {k: v.cpu().numpy() for k, v in ts.items()}
        return ts

    def _to(self, state: dict[str, Any], reset: bool, return_info: bool):
        raise NotImplementedError

    def close(self, **kwargs: Any) -> None:
        del kwargs

    # -- not ported yet ----------------------------------------------------

    def render(self, env_id: np.ndarray | None = None):
        raise NotImplementedError("render() is not ported to envpool_tpu_torch yet")

    def save_state(self, path: str) -> None:
        raise NotImplementedError(
            "save_state() is not ported to envpool_tpu_torch yet"
        )

    def load_state(self, path: str) -> None:
        raise NotImplementedError(
            "load_state() is not ported to envpool_tpu_torch yet"
        )

    # -- functional escape hatch -------------------------------------------

    @property
    def engine(self) -> Engine:
        """The underlying pure-functional engine."""
        return self._engine

    @property
    def pool_state(self):
        return self._state

    def xla(self):
        """Functional ``(handle, recv, send, step)``, like ``env.xla()``.

        The name is kept from the JAX package; the handle is the torch
        PoolState plus the last timestep (see ``adapters/functional.py``).
        """
        from .functional import make_functional

        return make_functional(self)
