"""The constraint solver's projected Gauss–Seidel sweeps as a hand-written
CUDA kernel.

No Pallas kernel of the JAX package does this: its
``physics/solver.py::constraint_force`` loops over rows and sweeps with
``jax.lax.fori_loop``, which XLA compiles into one device loop.  Eager
PyTorch would launch a few kernels per row update (tens of thousands per
solve), so the sweeps are one kernel here: ``csrc/pgs_solve.cu``, built for
``sm_90a`` at first use with ``torch.utils.cpp_extension.load`` into
``envpool_tpu_torch/_build/pgs_solve/`` and called through its plain C
interface with ``ctypes``.

:data:`pgs_solve` takes ``A [N, nr, nr]``, ``b``, ``R``, ``diag [N, nr]``
(float32 or float64) and ``active [N, nr]`` bool, and returns the forces
``f [N, nr]`` after ``iterations`` sweeps from 0.  On CPU tensors it runs
:func:`pgs_plain`; on CUDA tensors it launches the kernel, and any build
or launch error propagates.  ``pgs_solve.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import pathlib
import time

import torch

__all__ = ["PgsSolve", "pgs_plain", "pgs_solve"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "pgs_solve.cu"
_BUILD_DIR = _PKG / "_build" / "pgs_solve"
_CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
# Most active rows whose block of A a warp keeps in shared memory (~9 KB in
# float32, 8 KB in float64); an env with more reads A from device memory.
CACHED_ROWS = {torch.float32: 48, torch.float64: 32}
# Largest dynamic shared memory a Hopper block can use (227 KB).
_MAX_SMEM = 232448


def pgs_plain(A, b, R, diag, active, iterations: int) -> torch.Tensor:
    """The plain version: the JAX loop, vectorised over envs, a Python loop
    over the rows.  Rows active in no env are skipped (their force stays
    0, as in the JAX loop, where ``max(0, ·) · 0`` keeps it there)."""
    f = torch.zeros_like(b)
    act = active.to(b.dtype)
    rows = active.any(0).nonzero()[:, 0].tolist()
    for _ in range(iterations):
        for i in rows:
            fi = f[:, i]
            g = (A[:, i] * f).sum(-1) + b[:, i] + R[:, i] * fi
            f[:, i] = torch.clamp_min(fi - g / diag[:, i], 0.0) * act[:, i]
    return f


class PgsSolve:
    """The PGS wrapper: builds, checks, launches and counts launches."""

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
                name="envpool_tpu_torch_pgs_solve",
                sources=[str(_SOURCE)],
                extra_cuda_cflags=_CUDA_FLAGS,
                build_directory=str(_BUILD_DIR),
                is_python_module=False,
                verbose=False,
            )
            lib = ctypes.CDLL(path)
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            for name in ("pgs_solve_launch_f32", "pgs_solve_launch_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
                fn.restype = i32
            lib.pgs_reduce_chase_launch.argtypes = [ptr, i32, i32, ptr]
            lib.pgs_reduce_chase_launch.restype = i32
            lib.pgs_solve_error_string.argtypes = [i32]
            lib.pgs_solve_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _raise(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self._library().pgs_solve_error_string(rc).decode()
            raise RuntimeError(f"{what} kernel launch failed: {msg}")

    @staticmethod
    def _check(A, b, R, diag, active) -> None:
        if A.ndim != 3 or A.shape[1] != A.shape[2]:
            raise ValueError(f"pgs_solve wants A [N, nr, nr], got {tuple(A.shape)}")
        if A.dtype not in CACHED_ROWS:
            raise TypeError(f"pgs_solve wants float32 or float64, got {A.dtype}")
        n, nr = A.shape[:2]
        for name, t in (("b", b), ("R", R), ("diag", diag), ("active", active)):
            want = torch.bool if name == "active" else A.dtype
            if tuple(t.shape) != (n, nr) or t.dtype != want or t.device != A.device:
                raise ValueError(
                    f"pgs_solve: {name} must be [{n}, {nr}] {want} on {A.device}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")

    def __call__(self, A, b, R, diag, active, iterations: int) -> torch.Tensor:
        """``f [N, nr]``: ``iterations`` projected Gauss–Seidel sweeps."""
        self._check(A, b, R, diag, active)
        if A.device.type == "cpu":
            return pgs_plain(A, b, R, diag, active, iterations)
        if A.device.type != "cuda":
            raise ValueError(f"pgs_solve: no kernel for {A.device}")
        n, nr = b.shape
        cap = min(nr, CACHED_ROWS[A.dtype])
        smem = nr * (4 * A.element_size() + 4) + cap * cap * A.element_size()
        if smem > _MAX_SMEM:
            raise ValueError(f"pgs_solve: {nr} rows need more shared memory than a block has")
        lib = self._library()
        A, b, R, diag, active = (t.contiguous() for t in (A, b, R, diag, active))
        f = torch.empty_like(b)
        if n == 0 or nr == 0:
            return f.zero_()
        launch = (lib.pgs_solve_launch_f32 if A.dtype == torch.float32
                  else lib.pgs_solve_launch_f64)
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream(A.device).cuda_stream
            rc = launch(A.data_ptr(), b.data_ptr(), R.data_ptr(), diag.data_ptr(),
                        active.data_ptr(), f.data_ptr(), n, nr, int(iterations), cap,
                        stream)
        self._raise(rc, "pgs_solve")
        self.launches += 1
        return f

    def reduce_chase(self, iters: int, dtype=torch.float32, device="cuda") -> torch.Tensor:
        """One warp's chain of ``iters`` dependent warp-wide sums in
        ``dtype`` (a test entry; not counted in ``launches``): ``[2]``
        int64 on the card, the SM clocks the chain took and where it
        ended."""
        lib = self._library()
        out = torch.zeros(2, dtype=torch.int64, device=device)
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            rc = lib.pgs_reduce_chase_launch(out.data_ptr(), int(iters),
                                             int(dtype == torch.float64), stream)
        self._raise(rc, "pgs_reduce_chase")
        return out


pgs_solve = PgsSolve()
