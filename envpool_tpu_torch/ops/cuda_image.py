"""K1: fused max-pool + INTER_AREA resize as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``envpool_tpu/ops/pallas_image.py::_kernel``
(``fused_pool_resize``).  The kernel source is ``csrc/pool_resize.cu``; it
is built for ``sm_90a`` at first use with
``torch.utils.cpp_extension.load`` into ``envpool_tpu_torch/_build/pool_resize/`` and
called through its plain C interface with ``ctypes``.

:data:`fused_pool_resize` takes ``[N, 2, H, W]`` float32 frames and returns
``[N, h, w]`` uint8.  On a CPU tensor it runs the plain version
(``ops/image.pool_resize``); on a CUDA tensor it launches the kernel, and
any build or launch error propagates.  ``fused_pool_resize.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
import pathlib
import time

import numpy as np
import torch

from .image import area_bands, pool_resize

__all__ = ["fused_pool_resize"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "pool_resize.cu"
_BUILD_DIR = _PKG / "_build" / "pool_resize"
_CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
# Largest dynamic shared memory a Hopper block can use (227 KB).
_MAX_SMEM = 232448
# Output pixels a block aims to cover (a tile of whole output rows).
_TILE_PIXELS = 1024


class _Plan:
    """Band lists and tiling for one (in_hw, out_hw, device)."""

    def __init__(self, in_hw, out_hw, device):
        (H, W), (h, w) = in_hw, out_hw
        rs, rc, rw = area_bands(H, h)
        cs, cc, cw = area_bands(W, w)
        tiles = max(1, math.ceil(h * w / _TILE_PIXELS))
        th = math.ceil(h / tiles)
        while True:
            starts = np.arange(0, h, th)
            r0 = np.array([rs[o : o + th].min() for o in starts], np.int32)
            r1 = np.array(
                [(rs[o : o + th] + rc[o : o + th]).max() for o in starts],
                np.int32,
            )
            nr = r1 - r0
            if int(nr.max()) * W * 4 <= _MAX_SMEM or th == 1:
                break
            th = max(1, th // 2)
        if int(nr.max()) * W * 4 > _MAX_SMEM:
            raise ValueError(
                f"pool_resize: {in_hw} -> {out_hw} needs more shared memory "
                "than a block has"
            )

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        self.tensors = [dev(a) for a in (rs, rc, rw, cs, cc, cw, r0, nr)]
        self.dims = (H, W, h, w, rw.shape[1], cw.shape[1], th, int(nr.max()))


class FusedPoolResize:
    """The K1 wrapper: builds, checks, launches and counts launches."""

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None
        self._plans: dict = {}

    def build(self) -> float:
        """Build (or load the cached build of) the kernel; seconds taken."""
        t0 = time.perf_counter()
        self._library()
        return time.perf_counter() - t0

    def _library(self):
        if self._lib is None:
            from torch.utils.cpp_extension import load

            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            path = load(
                name="envpool_tpu_torch_pool_resize",
                sources=[str(_SOURCE)],
                extra_cuda_cflags=_CUDA_FLAGS,
                build_directory=str(_BUILD_DIR),
                is_python_module=False,
                verbose=False,
            )
            lib = ctypes.CDLL(path)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.pool_resize_launch.argtypes = [ptr] * 10 + [i32] * 9 + [ptr]
            lib.pool_resize_launch.restype = i32
            lib.pool_resize_error_string.argtypes = [i32]
            lib.pool_resize_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(
        self, frames: torch.Tensor, out_hw: tuple[int, int]
    ) -> torch.Tensor:
        """``[N, 2, H, W]`` float32 → ``[N, h, w]`` uint8."""
        if frames.ndim != 4 or frames.shape[1] != 2:
            raise ValueError(
                f"fused_pool_resize wants [N, 2, H, W], got {tuple(frames.shape)}"
            )
        if frames.dtype != torch.float32:
            raise TypeError(f"fused_pool_resize wants float32, got {frames.dtype}")
        h, w = int(out_hw[0]), int(out_hw[1])
        if frames.device.type == "cpu":
            return pool_resize(frames, (h, w))
        if frames.device.type != "cuda":
            raise ValueError(f"fused_pool_resize: no kernel for {frames.device}")
        if not frames.is_contiguous():
            raise ValueError("fused_pool_resize wants a contiguous tensor")
        lib = self._library()
        n, _, H, W = frames.shape
        key = ((H, W), (h, w), frames.device)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _Plan((H, W), (h, w), frames.device)
        out = torch.empty((n, h, w), dtype=torch.uint8, device=frames.device)
        if n == 0:
            return out
        with torch.cuda.device(frames.device):
            stream = torch.cuda.current_stream(frames.device).cuda_stream
            rc = lib.pool_resize_launch(
                frames.data_ptr(),
                out.data_ptr(),
                *(t.data_ptr() for t in plan.tensors),
                n,
                *plan.dims,
                stream,
            )
        if rc != 0:
            msg = lib.pool_resize_error_string(rc).decode()
            raise RuntimeError(f"pool_resize kernel launch failed: {msg}")
        self.launches += 1
        return out


fused_pool_resize = FusedPoolResize()
