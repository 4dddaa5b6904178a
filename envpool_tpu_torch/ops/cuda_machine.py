"""K2: one video frame of every 2600 machine, as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``envpool_tpu/envs/atari/machine_pallas.py
::_kernel`` (``frame_pallas``) together with the ``scatter_lines`` step
after it.  The kernel source is ``csrc/machine_frame.cu``; it is built for
``sm_90a`` at first use with ``torch.utils.cpp_extension.load`` into
``envpool_tpu_torch/_build/machine_frame/`` and called through its plain C interface
with ``ctypes``.

:data:`machine_frame` takes a machine batch in the JAX env's layout (the
dict of ``cpu6502.make_machine`` + ``tia.attach_tia``) and the cart's
tables (``machine_kernel.build_tables``) and returns the batch one frame
later.  On CPU tensors it runs the plain version
(``envs/atari/machine_kernel.frame``); on CUDA tensors it launches the
kernel, and any build or launch error propagates.
``machine_frame.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import pathlib
import time

import torch

from ..envs.atari import machine_kernel
from ..envs.atari.machine_kernel import NS, SCALARS
from ..envs.atari.tia import NREG, VISIBLE_LINES

__all__ = ["machine_frame"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "machine_frame.cu"
_BUILD_DIR = _PKG / "_build" / "machine_frame"
_CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

# The per-machine int32 arrays and their shapes after the batch dimension.
_FILES = {"ram": (128,), "tia": (64,), "cx": (8,), "lines": (VISIBLE_LINES, NREG)}


class MachineFrame:
    """The K2 wrapper: builds, checks, launches and counts launches."""

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None

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
                name="envpool_tpu_torch_machine_frame",
                sources=[str(_SOURCE)],
                extra_cuda_cflags=_CUDA_FLAGS,
                build_directory=str(_BUILD_DIR),
                is_python_module=False,
                verbose=False,
            )
            lib = ctypes.CDLL(path)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.machine_frame_launch.argtypes = (
                [ptr, i32] + [ptr] * 6 + [i32, ptr]
            )
            lib.machine_frame_launch.restype = i32
            lib.machine_collisions_launch.argtypes = [ptr, ptr, i32, ptr]
            lib.machine_collisions_launch.restype = i32
            lib.machine_frame_error_string.argtypes = [i32]
            lib.machine_frame_error_string.restype = ctypes.c_char_p
            lib.machine_frame_num_scalars.restype = i32
            if lib.machine_frame_num_scalars() != NS:
                raise RuntimeError("machine_frame.cu disagrees on the state layout")
            self._lib = lib
        return self._lib

    @staticmethod
    def _check(g: dict, tables: dict) -> torch.device:
        dev = g["pc"].device
        n = g["pc"].shape[0]
        for k in SCALARS:
            want = torch.bool if k == "wrapped" else torch.int32
            t = g[k]
            if t.dtype != want or tuple(t.shape) != (n,) or t.device != dev:
                raise ValueError(
                    f"machine_frame: {k} must be [{n}] {want} on {dev}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}"
                )
        for k, shape in _FILES.items():
            t = g[k]
            if t.dtype != torch.int32 or tuple(t.shape) != (n, *shape) or t.device != dev:
                raise ValueError(
                    f"machine_frame: {k} must be [{n}, {shape}] int32 on {dev}, "
                    f"got {tuple(t.shape)} {t.dtype} on {t.device}"
                )
        rom, dec = tables["rom"], tables["decode"]
        if rom.dtype != torch.uint8 or rom.ndim != 1 or rom.shape[0] not in (4096, 8192, 16384):
            raise ValueError("machine_frame: rom must be a 4K/8K/16K uint8 vector")
        if dec.dtype != torch.int32 or tuple(dec.shape) != (256, 4):
            raise ValueError("machine_frame: decode must be [256, 4] int32")
        if rom.device != dev or dec.device != dev:
            raise ValueError("machine_frame: tables and state on different devices")
        return dev

    def __call__(self, g: dict, tables: dict) -> dict:
        """A machine batch one video frame later (a new dict)."""
        dev = self._check(g, tables)
        if dev.type == "cpu":
            return machine_kernel.frame(g, tables)
        if dev.type != "cuda":
            raise ValueError(f"machine_frame: no kernel for {dev}")
        lib = self._library()
        n = g["pc"].shape[0]
        # Fresh, contiguous buffers that the kernel updates in place.
        scal = torch.stack([g[k].to(torch.int32) for k in SCALARS])
        files = {k: g[k].contiguous().clone() for k in _FILES}
        rom = tables["rom"].contiguous()
        dec = tables["decode"].contiguous()
        out = dict(g)
        if n:
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = lib.machine_frame_launch(
                    rom.data_ptr(), rom.shape[0], dec.data_ptr(),
                    scal.data_ptr(), files["ram"].data_ptr(),
                    files["tia"].data_ptr(), files["cx"].data_ptr(),
                    files["lines"].data_ptr(), n, stream,
                )
            if rc != 0:
                msg = lib.machine_frame_error_string(rc).decode()
                raise RuntimeError(f"machine_frame kernel launch failed: {msg}")
            self.launches += 1
        for i, k in enumerate(SCALARS):
            out[k] = scal[i] != 0 if k == "wrapped" else scal[i]
        out.update(files)
        return out

    def collisions(self, rec: torch.Tensor) -> torch.Tensor:
        """The kernel's collision bits of line records ``[N, 24]`` int32 on
        the card (a test entry; not counted in ``launches``)."""
        if rec.device.type != "cuda" or rec.dtype != torch.int32 or rec.ndim != 2 \
                or rec.shape[1] != NREG or not rec.is_contiguous():
            raise ValueError("machine_frame.collisions wants [N, 24] int32 on the card")
        lib = self._library()
        out = torch.empty((rec.shape[0], 8), dtype=torch.int32, device=rec.device)
        with torch.cuda.device(rec.device):
            stream = torch.cuda.current_stream(rec.device).cuda_stream
            rc = lib.machine_collisions_launch(
                rec.data_ptr(), out.data_ptr(), rec.shape[0], stream
            )
        if rc != 0:
            msg = lib.machine_frame_error_string(rc).decode()
            raise RuntimeError(f"machine_collisions kernel launch failed: {msg}")
        return out


machine_frame = MachineFrame()
