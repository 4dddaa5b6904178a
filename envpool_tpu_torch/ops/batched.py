"""Small batched tensor helpers shared by the env families: constants
made once per device, ``jnp.argmin``/``argmax``'s tie rule, ``jnp.mod``'s
float rounding, and float32 arithmetic as XLA rounds it (weakly typed
constants, a division by a constant, transcendentals rounded once from
float64, matmuls without TF32)."""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

__all__ = ["acos", "asin", "atan", "atan2", "const", "cos", "f32", "first_argmax",
           "first_argmin", "first_true", "full_fp32", "inv", "mod", "norm", "pow", "sin",
           "tan", "tanh"]


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


def first_true(x: torch.Tensor) -> torch.Tensor:
    """Index of the first true element along the last axis (0 where none
    is)."""
    return first_argmax(x.to(torch.int8))


def mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.mod`` for floats: ``fmod``, then ``+ m`` where the signs differ
    (``torch.remainder`` computes ``x - m * floor(x / m)``, which rounds
    differently)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def f32(c: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weakly typed
    constant against a float32 array."""
    return float(np.float32(c))


def inv(c: float) -> float:
    """``1 / c`` of the float32 constant ``c``, in float32: XLA turns
    ``x / c`` into ``x * (1 / c)``."""
    return float(np.float32(1.0) / np.float32(c))


def norm(x: torch.Tensor) -> torch.Tensor:
    """The Euclidean norm over the last axis."""
    return torch.sqrt((x * x).sum(-1))


@contextlib.contextmanager
def full_fp32():
    """Run CUDA float32 matmuls without TF32 inside the block, whatever the
    caller set; restore the caller's setting after.

    Uses the backend's ``fp32_precision`` setting, not the older
    ``allow_tf32`` flag: torch refuses some reads once both have been set.
    """
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = before


def _rounded(fn):
    """``fn`` in float64, rounded once to float32.  The card's and the CPU's
    float32 ``sin``, ``atan2`` or ``pow`` differ by an ulp on some inputs,
    and a decision (a lane change, a crash, a goal reached) amplifies an
    ulp past any tolerance; rounded from float64, both give the correctly
    rounded float32 value, the same bits."""
    def f(*args):
        return fn(*(a.double() if isinstance(a, torch.Tensor) else a for a in args)).float()

    f.__name__ = fn.__name__
    f.__doc__ = f"``torch.{fn.__name__}`` in float64, rounded once to float32."
    return f


sin, cos, tan, asin, acos, atan, atan2, tanh, pow = (_rounded(f) for f in (
    torch.sin, torch.cos, torch.tan, torch.asin, torch.acos, torch.atan, torch.atan2,
    torch.tanh, torch.pow))
