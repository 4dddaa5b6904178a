"""Small batched tensor helpers shared by the env families: constants
made once per device, ``jnp.argmin``/``argmax``'s tie rule, ``jnp.mod``'s
float rounding."""

from __future__ import annotations

import functools

import torch

__all__ = ["const", "first_argmax", "first_argmin", "mod"]


@functools.lru_cache(maxsize=None)
def const(values: tuple, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A constant tensor, copied to ``device`` once: a copy from pageable
    host memory on every step would make the host wait for the card."""
    return torch.tensor(values, dtype=dtype, device=device)


def first_argmin(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis (``jnp.argmin``'s
    choice on ties), computed without relying on a backend's tie rule."""
    if x.dtype == torch.bool:
        x = x.to(torch.int8)
    k = x.shape[-1]
    idx = torch.arange(k, device=x.device)
    low = x.min(-1, keepdim=True).values
    return torch.where(x == low, idx, k).min(-1).values


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis."""
    k = x.shape[-1]
    idx = torch.arange(k, device=x.device)
    high = x.max(-1, keepdim=True).values
    return torch.where(x == high, idx, k).min(-1).values


def mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.mod`` for floats: ``fmod``, then ``+ m`` where the signs differ
    (``torch.remainder`` computes ``x - m * floor(x / m)``, which rounds
    differently)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)
