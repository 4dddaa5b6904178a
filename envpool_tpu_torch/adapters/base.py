"""Stateful pool wrapper: the analog of ``EnvPoolMixin``, over torch state.

Counterpart of ``envpool_tpu/adapters/base.py``: batched ``step/reset/
send/recv/async_reset``, action normalization (dict or bare array,
optional ``env_id`` routing), and the sync/async split.  With
``batch_size < num_envs`` the pool runs partial steps (gather, step,
scatter over the addressed rows).  CUDA work is queued asynchronously, so
``send`` returns once the step is enqueued and ``recv`` waits for the
oldest one when it copies to numpy.

Also as in JAX: ``render`` (batched RGB frames of the env's
``render_state``; ``render_mode="human"`` tiles them into one OpenCV
window), ``save_state`` / ``load_state`` (an ``.npz`` of the pool state's
leaves, checked on load) and ``record_dir`` (``adapters/record.py``).
"""

from __future__ import annotations

from collections import deque
from typing import Any

import numpy as np
import torch

from ..core.engine import Engine, PoolState, TimeStepDict, _tree_map
from ..core.env import TorchEnv
from ..core.env_spec import EnvSpec

__all__ = ["EnvPoolBase", "tile_frames"]

_POOL_FIELDS = ("env_state", "key", "elapsed", "autoreset", "full_reset")


def tile_frames(frames: np.ndarray) -> np.ndarray:
    """Tile ``[B, H, W, 3]`` frames into one near-square grid image.

    The human-mode viewer shows the whole batch at once (the reference
    limits human mode to a single env, ``envpool/python/envpool.py:289-293``
    — the grid is the batched generalization).
    """
    frames = np.asarray(frames)
    b, h, w, c = frames.shape
    cols = int(np.ceil(np.sqrt(b)))
    rows = int(np.ceil(b / cols))
    grid = np.zeros((rows * h, cols * w, c), frames.dtype)
    for i in range(b):
        r, cidx = divmod(i, cols)
        grid[r * h : (r + 1) * h, cidx * w : (cidx + 1) * w] = frames[i]
    return grid


def _flatten(ps: PoolState) -> tuple[list[torch.Tensor], str]:
    """The pool state's leaves in a fixed order and a description of its
    structure (dict keys nested, ``*`` for a leaf)."""
    leaves: list[torch.Tensor] = []

    def walk(tree) -> str:
        if isinstance(tree, dict):
            return "{" + ", ".join(f"{k!r}: {walk(v)}" for k, v in tree.items()) + "}"
        leaves.append(tree)
        return "*"

    desc = ", ".join(f"{f}={walk(getattr(ps, f))}" for f in _POOL_FIELDS)
    return leaves, f"PoolState({desc})"


def _numpy_dtype(t: torch.Tensor) -> np.dtype:
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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
        rec = str(
            self._env.config.get("record_dir")
            or self._env.config.get("lmp_save_dir")
            or ""
        )
        self._recorder = None
        if rec:
            from .record import EpisodeRecorder

            self._recorder = EpisodeRecorder(rec, self.num_envs, self._env.seeds())

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
        if self._recorder is not None:
            self._recorder.on_send(
                self.all_env_ids if env_id is None else _host(env_id),
                {k: _host(v) for k, v in tree.items()},
            )
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
        out = self._materialize(ts)
        if self._recorder is not None:
            self._recorder.on_recv(_host(out["info:env_id"]), _host(out["done"]))
        return self._to(out, reset, return_info)

    def async_reset(self) -> None:
        """Reset all envs, delivering results in ``batch_size`` chunks."""
        if self._recorder is not None:
            self._recorder.on_reset(self.all_env_ids)
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
        if self._recorder is not None:
            self._recorder.on_reset(_host(env_id))
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

    # -- render ------------------------------------------------------------

    def render(self, env_id: np.ndarray | None = None) -> np.ndarray | None:
        """Batched RGB frames ``[B, H, W, 3]`` uint8 of the addressed envs.

        The analog of ``AsyncEnvPool::Render`` (``core/async_envpool.h:
        183-222``), drawn on the pool's device by the env's batched
        ``render_state``.  With ``render_mode="human"`` (reference
        ``envpool/python/envpool.py:264-295``) the batch is tiled into one
        grid image and shown in an OpenCV window; returns None.
        """
        if env_id is None:
            env_id = self.all_env_ids
        ids = self._tensor(env_id, torch.int64)
        states = _tree_map(lambda x: x.index_select(0, ids), self._state.env_state)
        out = self._env.render_state(states).cpu().numpy()
        if self.config.get("render_mode", "rgb_array") == "human":
            self._show_human_frame(tile_frames(out))
            return None
        return out

    def _show_human_frame(self, frame: np.ndarray) -> None:
        """Display one RGB frame in a (reused) OpenCV window, as
        ``EnvPoolMixin._show_human_frame`` does (``envpool/python/
        envpool.py:246-263``)."""
        try:
            import cv2
        except ImportError as exc:
            raise RuntimeError(
                "render_mode='human' requires opencv-python to be installed"
            ) from exc
        window_name = getattr(
            self, "_render_window_name", f"{self.__class__.__name__}-render"
        )
        cv2.imshow(window_name, np.ascontiguousarray(frame[:, :, ::-1]))
        cv2.waitKey(1)
        self._render_window_name = window_name

    # -- checkpoint / resume -----------------------------------------------

    def save_state(self, path: str) -> None:
        """Snapshot the full pool state (all envs) to an .npz file."""
        leaves, desc = _flatten(self._state)
        np.savez(
            path, *(x.cpu().numpy() for x in leaves),
            __treedef__=np.frombuffer(desc.encode(), dtype=np.uint8),
        )

    def load_state(self, path: str) -> None:
        """Restore a snapshot taken by :meth:`save_state`.

        Fails loudly if the snapshot was taken under a different config:
        the stored structure and every leaf's shape and dtype must match
        the current pool's, or leaves would land in the wrong fields.
        """
        with np.load(path) as data:
            count = sum(f.startswith("arr_") for f in data.files)
            leaves = [data[f"arr_{i}"] for i in range(count)]
            stored = (
                bytes(data["__treedef__"]).decode() if "__treedef__" in data else None
            )
        cur_leaves, desc = _flatten(self._state)
        if stored is not None and stored != desc:
            raise ValueError(
                "load_state: snapshot treedef does not match this pool's "
                "state tree (was the snapshot taken with a different env "
                f"config?).\n  stored:  {stored}\n  current: {desc}"
            )
        if len(leaves) != len(cur_leaves):
            raise ValueError(
                f"load_state: snapshot has {len(leaves)} leaves, pool state "
                f"has {len(cur_leaves)}"
            )
        for i, (new, cur) in enumerate(zip(leaves, cur_leaves)):
            if tuple(new.shape) != tuple(cur.shape) or new.dtype != _numpy_dtype(cur):
                raise ValueError(
                    f"load_state: leaf {i} mismatch — snapshot "
                    f"{new.dtype}{tuple(new.shape)} vs pool "
                    f"{_numpy_dtype(cur)}{tuple(cur.shape)}"
                )
        it = iter(torch.from_numpy(np.ascontiguousarray(a)).to(self._device) for a in leaves)

        def fill(tree):
            if isinstance(tree, dict):
                return {k: fill(v) for k, v in tree.items()}
            return next(it)

        self._state = PoolState(*(fill(getattr(self._state, f)) for f in _POOL_FIELDS))
        self._recv_queue.clear()

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
