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
from ..envs.atari.cpu6502 import CPU_TABLES
from ..envs.atari.machine_kernel import NS, SCALARS
from ..envs.atari.tia import NREG, VISIBLE_LINES

__all__ = ["MachineFrame", "machine_frame"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "machine_frame.cu"
_BUILD_DIR = _PKG / "_build" / "machine_frame"
_CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

# The per-machine int32 arrays and their shapes after the batch dimension.
_FILES = {"ram": (128,), "tia": (64,), "cx": (8,), "lines": (VISIBLE_LINES, NREG)}
# Machines per warp: the default build has MACHINES_PER_WARP; a build with
# -DK2_ALL_GEOMETRIES (tools/k2_probe.py's) has all of GEOMETRIES.
GEOMETRIES = (1, 4, 8, 32)
MACHINES_PER_WARP = 4


class MachineFrame:
    """The K2 wrapper: builds, checks, launches and counts launches.

    ``machines_per_warp`` (one of :data:`GEOMETRIES` the build has) sets
    how many machines share a warp.
    """

    def __init__(self, source: pathlib.Path = _SOURCE,
                 build_dir: pathlib.Path = _BUILD_DIR,
                 name: str = "envpool_tpu_torch_machine_frame",
                 extra_cflags: tuple = ()) -> None:
        self.launches = 0
        self.machines_per_warp = MACHINES_PER_WARP
        self._lib = None
        self._source, self._build_dir, self._name = source, build_dir, name
        self._flags = _CUDA_FLAGS + list(extra_cflags)

    def build(self) -> float:
        """Build (or load the cached build of) the kernel; seconds taken."""
        t0 = time.perf_counter()
        self._library()
        return time.perf_counter() - t0

    def _library(self):
        if self._lib is None:
            from torch.utils.cpp_extension import load

            self._build_dir.mkdir(parents=True, exist_ok=True)
            path = load(
                name=self._name,
                sources=[str(self._source)],
                extra_cuda_cflags=self._flags,
                build_directory=str(self._build_dir),
                is_python_module=False,
                verbose=False,
            )
            lib = ctypes.CDLL(path)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.machine_frame_launch.argtypes = (
                [ptr, i32] + [ptr] * 6 + [i32, i32, ptr]
            )
            lib.machine_frame_launch.restype = i32
            lib.machine_collisions_launch.argtypes = [ptr, ptr, i32, ptr]
            lib.machine_collisions_launch.restype = i32
            lib.machine_smem_chase_launch.argtypes = [ptr, i32, ptr]
            lib.machine_smem_chase_launch.restype = i32
            lib.machine_frame_error_string.argtypes = [i32]
            lib.machine_frame_error_string.restype = ctypes.c_char_p
            lib.machine_frame_num_scalars.restype = i32
            if lib.machine_frame_num_scalars() != NS:
                raise RuntimeError("machine_frame.cu disagrees on the state layout")
            decode = (ctypes.c_uint32 * 256)()
            lib.machine_frame_decode(decode)
            mode, op, size, cyc = (t.tolist() for t in CPU_TABLES)
            want = [m | (o << 8) | (z << 16) | (c << 24)
                    for m, o, z, c in zip(mode, op, size, cyc)]
            if list(decode) != want:
                raise RuntimeError("machine_frame.cu disagrees on the decode table")
            self._lib = lib
        return self._lib

    @staticmethod
    def _check(g: dict, tables: dict, counts) -> torch.device:
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
        fetch, nbanks = tables["fetch"], tables["nbanks"]
        if nbanks not in (1, 2, 4) or fetch.dtype != torch.int64 \
                or tuple(fetch.shape) != (nbanks * 4096,):
            raise ValueError("machine_frame: fetch must be [nbanks * 4096] int64 "
                             "for 1, 2 or 4 banks")
        if fetch.device != dev:
            raise ValueError("machine_frame: tables and state on different devices")
        if counts is not None and (counts.dtype != torch.int32 or counts.device != dev
                                   or tuple(counts.shape) != (n,)
                                   or not counts.is_contiguous()):
            raise ValueError(f"machine_frame: counts must be [{n}] int32 on {dev}")
        return dev

    def _raise(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self._library().machine_frame_error_string(rc).decode()
            raise RuntimeError(f"{what} kernel launch failed: {msg}")

    def __call__(self, g: dict, tables: dict,
                 counts: torch.Tensor | None = None) -> dict:
        """A machine batch one video frame later (a new dict).  Given
        ``counts`` (``[N]`` int32 on the state's device), each machine's
        number of emulated instructions in the frame is written there."""
        dev = self._check(g, tables, counts)
        if dev.type == "cpu":
            return machine_kernel.frame(g, tables, counts)
        if dev.type != "cuda":
            raise ValueError(f"machine_frame: no kernel for {dev}")
        lib = self._library()
        n = g["pc"].shape[0]
        # Fresh, contiguous buffers that the kernel updates in place.
        scal = torch.stack([g[k].to(torch.int32) for k in SCALARS])
        files = {k: g[k].contiguous().clone() for k in _FILES}
        fetch = tables["fetch"].contiguous()
        if fetch.data_ptr() % 16:
            raise ValueError("machine_frame: the fetch table must be 16-byte aligned")
        out = dict(g)
        if n:
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = lib.machine_frame_launch(
                    fetch.data_ptr(), tables["nbanks"], scal.data_ptr(),
                    files["ram"].data_ptr(), files["tia"].data_ptr(),
                    files["cx"].data_ptr(), files["lines"].data_ptr(),
                    None if counts is None else counts.data_ptr(), n,
                    self.machines_per_warp, stream,
                )
            self._raise(rc, "machine_frame")
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
        self._raise(rc, "machine_collisions")
        return out

    def smem_chase(self, iters: int, device="cuda") -> torch.Tensor:
        """One thread's chain of ``iters`` dependent shared-memory loads (a
        test entry; not counted in ``launches``): ``[2]`` int64 on the
        card, the SM clocks the chain took and where it ended."""
        if iters <= 0 or iters % 8:
            raise ValueError("machine_frame.smem_chase wants a positive multiple of 8")
        lib = self._library()
        out = torch.zeros(2, dtype=torch.int64, device=device)
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            rc = lib.machine_smem_chase_launch(out.data_ptr(), iters, stream)
        self._raise(rc, "machine_smem_chase")
        return out


machine_frame = MachineFrame()
