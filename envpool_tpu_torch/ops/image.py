"""Image preprocessing ops: the plain PyTorch version of K1.

Counterpart of ``envpool_tpu/ops/image.py``.  INTER_AREA resize is a linear
map, ``out = Wh @ img @ Ww``, with the area-overlap weights of
:func:`_area_weights` (copied unchanged from the JAX package).  On the card
the arcade env does max-pool + resize in the CUDA kernel of
``ops/cuda_image.py``; this module is that kernel's plain version, which
the CPU path runs and which the kernel is held against.

Rounding is half-to-even (``torch.round``, like ``jnp.round``).  Because
the weights for 210→84 and 160→84 are multiples of 1/5 and 1/40, some
integer inputs land exactly on ``k + 0.5``; there two float32 summation
orders may round to different sides.  :func:`area_ties` finds those
pixels from a float64 evaluation, and :func:`tie_rule_violations` counts
the pixels where two results differ anywhere else, or by more than 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "area_bands",
    "area_ties",
    "grayscale",
    "maxpool2",
    "pool_resize",
    "resize_area",
    "resize_matrices",
    "tie_rule_violations",
]


@functools.lru_cache(maxsize=64)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) area-overlap averaging weights (rows sum to 1)."""
    w = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for o in range(n_out):
        lo = o * scale
        hi = (o + 1) * scale
        i0 = int(np.floor(lo))
        i1 = int(np.ceil(hi))
        for i in range(i0, min(i1, n_in)):
            cover = min(hi, i + 1) - max(lo, i)
            if cover > 0:
                w[o, i] = cover
        w[o] /= w[o].sum()
    return w


def resize_matrices(
    in_hw: tuple[int, int],
    out_hw: tuple[int, int],
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Wh [h, H], Ww [W, w]) weight matrices for ``out = Wh @ img @ Ww``."""
    wh = torch.as_tensor(_area_weights(in_hw[0], out_hw[0]))
    ww = torch.as_tensor(_area_weights(in_hw[1], out_hw[1]).T.copy())
    return wh.to(device, dtype), ww.to(device, dtype)


def area_bands(
    n_in: int, n_out: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Banded form of :func:`_area_weights` for the CUDA kernel.

    Returns ``(start [n_out] int32, count [n_out] int32, weight [n_out, K]
    float32)``: output ``o`` reads inputs ``start[o] .. start[o]+count[o]-1``
    with ``weight[o, :count[o]]``, the same float32 values as the dense row.
    Works for downscales and upscales alike.
    """
    dense = _area_weights(n_in, n_out)
    nz = dense != 0
    start = nz.argmax(axis=1).astype(np.int32)
    stop = (n_in - nz[:, ::-1].argmax(axis=1)).astype(np.int32)
    count = stop - start
    k = int(count.max())
    weight = np.zeros((n_out, k), np.float32)
    for o in range(n_out):
        weight[o, : count[o]] = dense[o, start[o] : stop[o]]
    return start, count, weight


def resize_area(
    img: torch.Tensor, out_hw: tuple[int, int], dtype=torch.uint8
) -> torch.Tensor:
    """INTER_AREA resize of ``[..., H, W]`` images as two matmuls."""
    h, w = img.shape[-2], img.shape[-1]
    work = torch.float64 if dtype == torch.float64 else torch.float32
    wh, ww = resize_matrices((h, w), out_hw, img.device, work)
    x = torch.matmul(wh, img.to(work))  # [..., H, W] -> [..., h, W]
    x = torch.matmul(x, ww)  # [..., h, W] -> [..., h, w]
    if not dtype.is_floating_point:
        x = torch.clamp(torch.round(x), 0, 255)
    return x.to(dtype)


def grayscale(rgb: torch.Tensor, dtype=torch.uint8) -> torch.Tensor:
    """ITU-R 601 luma of ``[..., 3, H, W]`` (channel-first) images."""
    r = rgb[..., 0, :, :].to(torch.float32)
    g = rgb[..., 1, :, :].to(torch.float32)
    b = rgb[..., 2, :, :].to(torch.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    if not dtype.is_floating_point:
        y = torch.clamp(torch.round(y), 0, 255)
    return y.to(dtype)


def maxpool2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise max of two frames (flicker removal, atari_env.h:295)."""
    return torch.maximum(a, b)


def pool_resize(frames: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``[N, 2, H, W]`` float32 → ``[N, h, w]`` uint8: max-pool + area resize.

    The plain version of K1 (``ops/cuda_image.fused_pool_resize``).
    """
    return resize_area(maxpool2(frames[:, 0], frames[:, 1]), out_hw)


def area_ties(
    f0: torch.Tensor,
    f1: torch.Tensor,
    out_hw: tuple[int, int],
    atol: float = 1e-4,
) -> torch.Tensor:
    """``[..., h, w]`` bool: where ``resize(max(f0, f1))`` is a ``k + 0.5`` tie.

    Evaluated in float64 (``Wh64 @ pooled64 @ Ww64``), so float32 summation
    order cannot move a pixel in or out of the set.
    """
    pooled = maxpool2(f0, f1).to(torch.float64)
    exact = resize_area(pooled, out_hw, torch.float64)
    return (exact - torch.floor(exact) - 0.5).abs() < atol


def tie_rule_violations(
    a: torch.Tensor, b: torch.Tensor, ties: torch.Tensor
) -> tuple[int, int]:
    """``(violations, tie_mismatches)`` between two uint8 resize results.

    A violation is a pixel that differs outside ``ties``, or by more than 1
    anywhere.  ``tie_mismatches`` counts the allowed ±1 differences at ties.
    """
    diff = (a.to(torch.int16) - b.to(torch.int16)).abs()
    bad = ((diff > 0) & ~ties) | (diff > 1)
    return int(bad.sum()), int(((diff == 1) & ties).sum())
