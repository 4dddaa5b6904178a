"""Carry pool state between ``envpool_tpu`` and ``envpool_tpu_torch``.

A JAX ``PoolState`` fetched to the host (``jax.device_get``) is a tree of
numpy arrays with the fields ``env_state``, ``key``, ``elapsed``,
``autoreset`` and ``full_reset``.  :func:`pool_state_from_numpy` turns such
a tree (as a dict, e.g. ``dataclasses.asdict`` of it) into the port's
``PoolState`` on a device; :func:`pool_state_to_numpy` turns it back.

The JAX env state and the port's share their layout (same dict keys,
shapes and dtypes), so only the key changes form: JAX's ``[N, 2]`` uint32
threefry key becomes the port's ``[N, 2]`` int64 stream key with the same
two words.  The port does not reproduce threefry's bits from it; the
conversion only makes the round trip lossless.
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
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


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


def pool_state_to_numpy(ps: PoolState) -> dict[str, Any]:
    """The port's ``PoolState`` → a host tree in the JAX layout."""
    return {
        "env_state": _to_numpy(ps.env_state),
        "key": ps.key.cpu().numpy().astype(np.uint32),
        "elapsed": _to_numpy(ps.elapsed),
        "autoreset": _to_numpy(ps.autoreset),
        "full_reset": _to_numpy(ps.full_reset),
    }
