"""dm_control's ``rewards.tolerance`` on tensors.

Counterpart of ``envpool_tpu/envs/mujoco_dmc/rewards.py`` (reference
``envpool/mujoco/dmc/utils.h:54-60`` and dm_control's
``utils/rewards.py``): 1 inside ``bounds``, falling off outside through a
sigmoid-shaped shoulder of width ``margin`` that reaches
``value_at_margin`` at its edge.  Bad arguments raise the same
``ValueError`` as there, when the reward is built.
"""

from __future__ import annotations

import math

import torch

_DEFAULT_VALUE_AT_MARGIN = 0.1


def _sigmoid(x, value_at_1, sigmoid: str):
    if sigmoid in ("cosine", "linear", "quadratic"):
        if not 0 <= value_at_1 < 1:
            raise ValueError(f"value_at_1 must be in [0,1), got {value_at_1}")
    elif not 0 < value_at_1 < 1:
        raise ValueError(f"value_at_1 must be in (0,1), got {value_at_1}")
    if sigmoid == "gaussian":
        scale = math.sqrt(-2 * math.log(value_at_1))
        return torch.exp(-0.5 * (x * scale) ** 2)
    if sigmoid == "hyperbolic":
        scale = math.acosh(1 / value_at_1)
        return 1 / torch.cosh(x * scale)
    if sigmoid == "long_tail":
        scale = math.sqrt(1 / value_at_1 - 1)
        return 1 / ((x * scale) ** 2 + 1)
    if sigmoid == "reciprocal":
        scale = 1 / value_at_1 - 1
        return 1 / (x.abs() * scale + 1)
    if sigmoid == "cosine":
        scaled = x * (math.acos(2 * value_at_1 - 1) / math.pi)
        return torch.where(scaled.abs() < 1, (1 + torch.cos(math.pi * scaled)) / 2, 0.0)
    if sigmoid == "linear":
        scaled = x * (1 - value_at_1)
        return torch.where(scaled.abs() < 1, 1 - scaled.abs(), 0.0)
    if sigmoid == "quadratic":
        scaled = x * math.sqrt(1 - value_at_1)
        return torch.where(scaled.abs() < 1, 1 - scaled**2, 0.0)
    if sigmoid == "tanh_squared":
        scale = math.atanh(math.sqrt(1 - value_at_1))
        return 1 - torch.tanh(x * scale) ** 2
    raise ValueError(f"unknown sigmoid {sigmoid!r}")


def tolerance(
    x: torch.Tensor,
    bounds=(0.0, 0.0),
    margin: float = 0.0,
    sigmoid: str = "gaussian",
    value_at_margin: float = _DEFAULT_VALUE_AT_MARGIN,
) -> torch.Tensor:
    """Smooth indicator of ``x`` lying within ``bounds``, elementwise."""
    lower, upper = bounds
    if lower > upper:
        raise ValueError("lower bound must be <= upper bound")
    if margin < 0:
        raise ValueError("margin must be non-negative")
    in_bounds = (lower <= x) & (x <= upper)
    if margin == 0:
        return in_bounds.to(x.dtype)
    d = torch.where(x < lower, lower - x, x - upper) / margin
    return torch.where(in_bounds, 1.0, _sigmoid(d, value_at_margin, sigmoid))
