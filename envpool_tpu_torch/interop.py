"""Carry pool state between ``envpool_tpu`` and ``envpool_tpu_torch``.

A JAX ``PoolState`` fetched to the host (``jax.device_get``) is a tree of
numpy arrays with the fields ``env_state``, ``key``, ``elapsed``,
``autoreset`` and ``full_reset``.  :func:`pool_state_from_numpy` turns such
a tree (as a dict, e.g. ``dataclasses.asdict`` of it) into the port's
``PoolState`` on a device; :func:`pool_state_to_numpy` turns it back.

The JAX env state and the port's share their layout (same dict keys and
shapes, and the same dtypes but one), so two things change form: JAX's
``[N, 2]`` uint32 threefry key becomes the port's ``[N, 2]`` int64 stream
key with the same two words (the port does not reproduce threefry's bits
from it), and a uint32 leaf of the env state (the board games' Zobrist
hashes) becomes an int32 leaf of the same bits, since torch has few uint32
ops (XOR and equality are the same on either view).  Given the JAX tree
as ``like``, :func:`pool_state_to_numpy` gives such leaves back as
uint32, so the round trip is lossless.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.engine import PoolState

__all__ = ["pool_state_from_numpy", "pool_state_to_numpy"]

_FIELDS = ("env_state", "key", "elapsed", "autoreset", "full_reset")


def _to_torch(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _to_numpy(tree: Any, like: Any = None) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v, None if like is None else like[k]) for k, v in tree.items()}
    arr = tree.detach().cpu().numpy()
    if like is not None and np.asarray(like).dtype == np.uint32 and arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return arr


def pool_state_from_numpy(
    tree: dict[str, Any], device: torch.device | str
) -> PoolState:
    """A host tree of a JAX ``PoolState`` → the port's ``PoolState``."""
    device = torch.device(device)
    missing = set(_FIELDS) - set(tree)
    if missing:
        raise KeyError(f"pool state tree lacks {sorted(missing)}")
    key = np.asarray(tree["key"])
    if key.ndim != 2 or key.shape[1] != 2:
        raise ValueError(f"expected [N, 2] keys, got shape {key.shape}")
    return PoolState(
        env_state=_to_torch(tree["env_state"], device),
        key=torch.from_numpy(key.astype(np.int64)).to(device),
        elapsed=_to_torch(tree["elapsed"], device),
        autoreset=_to_torch(tree["autoreset"], device),
        full_reset=_to_torch(tree["full_reset"], device),
    )


def pool_state_to_numpy(ps: PoolState, like: dict[str, Any] | None = None) -> dict[str, Any]:
    """The port's ``PoolState`` → a host tree in the JAX layout; with
    ``like`` (a host tree of a JAX ``PoolState``), its uint32 env-state
    leaves come back as uint32."""
    return {
        "env_state": _to_numpy(ps.env_state, None if like is None else like["env_state"]),
        "key": ps.key.cpu().numpy().astype(np.uint32),
        "elapsed": _to_numpy(ps.elapsed),
        "autoreset": _to_numpy(ps.autoreset),
        "full_reset": _to_numpy(ps.full_reset),
    }
