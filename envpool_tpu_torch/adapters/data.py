"""Flat-key ↔ pytree layout logic for the API adapters.

Semantics mirror ``envpool/python/data.py``: flat state keys use ``:`` and
``.`` to encode nesting (``info:players.env_id`` → ``info.players.env_id``);
the dm_env layout merges ``obs`` and ``info:*`` into one ``State`` namedtuple
(``data.py:164-188``), the gymnasium layout keeps a plain nested dict
(``data.py:191-206``).  Spec→space conversion follows the same
discrete-vs-box heuristic with ``ACTION_THRESHOLD = 2**20``
(``data.py:29-60``).
"""

from __future__ import annotations

import keyword
import re
from collections import namedtuple
from typing import Any

import numpy as np

from ..core.specs import ArraySpec

ACTION_THRESHOLD = 2**20


def to_nested_dict(flat: dict[str, Any]) -> dict[str, Any]:
    """``{"a.b": v}`` → ``{"a": {"b": v}}``."""
    ret: dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split(".")
        ptr = ret
        for s in parts[:-1]:
            ptr = ptr.setdefault(s, {})
        ptr[parts[-1]] = v
    return ret


def to_gym_dict_space(nested: dict[str, Any]):
    """Nested plain dict of spaces → ``gymnasium.spaces.Dict`` recursively.

    Mirrors the reference's dotted-key space nesting
    (``envpool/python/data.py:164-206``) for keys like
    ``nodes.coordinates`` that produce sub-dicts.
    """
    import gymnasium

    return gymnasium.spaces.Dict(
        {
            k: to_gym_dict_space(v) if isinstance(v, dict) else v
            for k, v in nested.items()
        }
    )


def _identifier(name: str) -> str:
    field = re.sub(r"\W", "_", name)
    if not field or field[0].isdigit() or keyword.iskeyword(field):
        field = f"_{field}"
    return field


def to_namedtuple(name: str, hdict: dict) -> tuple:
    """Hierarchical dict → nested namedtuple (dm_env observation layout)."""
    fields = []
    used: dict[str, int] = {}
    for key in hdict:
        field = _identifier(key)
        if field in used:
            used[field] += 1
            field = f"{field}_{used[field]}"
        else:
            used[field] = 0
        fields.append(field)
    cls = namedtuple(_identifier(name), fields)
    return cls(*[
        to_namedtuple(k, v) if isinstance(v, dict) else v
        for k, v in hdict.items()
    ])


def dm_state_keys(keys: list[str], root: str = "State") -> list[str]:
    """Rewrite flat keys into the dm_env merged obs+info namespace."""
    out = []
    for key in keys:
        if key in ("obs", "info"):
            key = f"obs:{key}"
        key = key.replace("info:", "obs:").replace("obs:", f"{root}:")
        out.append(key.replace(":", "."))
    return out


def gym_state_keys(keys: list[str]) -> list[str]:
    return [k.replace(":", ".") for k in keys]


# -- spec → space/spec conversion ------------------------------------------


def _maybe_scalar_int(value: Any) -> int | None:
    arr = np.asarray(value)
    if arr.size != 1:
        return None
    scalar = arr.item()
    if not np.isfinite(scalar):
        return None
    integer = int(scalar)
    if not np.isclose(scalar, integer):
        return None
    return integer


def _maybe_discrete_range(
    spec: ArraySpec, spec_type: str
) -> tuple[int, int] | None:
    if np.prod([abs(s) for s in spec.shape]) != 1 and spec.shape != ():
        return None
    minimum = _maybe_scalar_int(spec.minimum)
    maximum = _maybe_scalar_int(spec.maximum)
    if minimum is None or maximum is None or maximum >= ACTION_THRESHOLD:
        return None
    if spec_type == "act":
        if not (spec.is_discrete or np.issubdtype(spec.dtype, np.integer)):
            return None
    elif not np.issubdtype(spec.dtype, np.integer):
        return None
    return minimum, maximum - minimum + 1


def _concrete_shape(spec: ArraySpec) -> list[int]:
    return [s for s in spec.shape if s != -1]


def dm_spec_transform(name: str, spec: ArraySpec, spec_type: str):
    """ArraySpec → dm_env.specs.{DiscreteArray,BoundedArray}."""
    import dm_env.specs

    discrete = _maybe_discrete_range(spec, spec_type)
    if discrete is not None and discrete[0] == 0:
        return dm_env.specs.DiscreteArray(
            name=name,
            dtype=spec.dtype
            if np.issubdtype(spec.dtype, np.integer)
            else np.int32,
            num_values=discrete[1],
        )
    return dm_env.specs.BoundedArray(
        name=name,
        shape=_concrete_shape(spec),
        dtype=spec.dtype,
        minimum=spec.minimum,
        maximum=spec.maximum,
    )


def gym_spec_transform(name: str, spec: ArraySpec, spec_type: str):
    """ArraySpec → gymnasium.spaces.{Discrete,MultiBinary,Box}."""
    import gymnasium

    discrete = _maybe_discrete_range(spec, spec_type)
    if discrete is not None:
        start, num_values = discrete
        return gymnasium.spaces.Discrete(n=num_values, start=start)
    if np.issubdtype(spec.dtype, np.bool_):
        return gymnasium.spaces.MultiBinary(_concrete_shape(spec))

    def bound(v):
        arr = np.asarray(v)
        return arr.item() if arr.ndim == 0 else arr.astype(spec.dtype)

    return gymnasium.spaces.Box(
        shape=_concrete_shape(spec),
        dtype=spec.dtype,
        low=bound(spec.minimum),
        high=bound(spec.maximum),
    )
