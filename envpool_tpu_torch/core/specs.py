"""Array specs for the PyTorch env engine.

Counterpart of ``envpool_tpu/core/specs.py``: an :class:`ArraySpec` carries
a numpy dtype, per-env shape, bounds (scalar or element-wise) and a
discreteness flag, plus the matching ``torch_dtype`` for device tensors.
A leading ``-1`` dimension marks a per-player axis, materialised as
``max_num_players`` at batch time.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

__all__ = ["ArraySpec", "torch_dtype"]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(dtype: Any) -> torch.dtype:
    """The torch dtype of a numpy dtype (or anything ``np.dtype`` takes)."""
    return _TORCH_DTYPES[np.dtype(dtype)]


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Static description of one array field of a state or action tree."""

    dtype: Any
    shape: tuple[int, ...] = ()
    minimum: Any = None
    maximum: Any = None
    is_discrete: bool = False

    def __post_init__(self) -> None:
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        lo, hi = self.minimum, self.maximum
        if lo is None:
            lo = _default_min(self.dtype)
        if hi is None:
            hi = _default_max(self.dtype)
        object.__setattr__(self, "minimum", _canon_bound(lo))
        object.__setattr__(self, "maximum", _canon_bound(hi))

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def per_player(self) -> bool:
        """True if the leading dim is the per-player axis (-1 sentinel)."""
        return len(self.shape) > 0 and self.shape[0] == -1

    def static_shape(self, max_num_players: int = 1) -> tuple[int, ...]:
        """Concrete per-env shape; single-player pools drop the player axis."""
        if not self.per_player:
            return self.shape
        if max_num_players == 1:
            return self.shape[1:]
        return (max_num_players, *self.shape[1:])

    def __repr__(self) -> str:
        return (
            f"ArraySpec(shape={list(self.shape)}, dtype={self.dtype}, "
            f"minimum={self.minimum}, maximum={self.maximum})"
        )


def _canon_bound(value: Any) -> Any:
    arr = np.asarray(value)
    if arr.ndim == 0:
        return arr.item()
    return arr


def _default_min(dtype: np.dtype) -> Any:
    if np.issubdtype(dtype, np.floating):
        return float("-inf")
    if dtype == np.bool_:
        return False
    return int(np.iinfo(dtype).min)


def _default_max(dtype: np.dtype) -> Any:
    if np.issubdtype(dtype, np.floating):
        return float("inf")
    if dtype == np.bool_:
        return True
    return int(np.iinfo(dtype).max)

