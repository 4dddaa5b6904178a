"""The constraint solver after its rows (``A = J M⁻¹ Jᵀ`` of the active
rows, the projected Gauss–Seidel sweeps and ``Jᵀf``) as a hand-written
CUDA kernel.

No Pallas kernel of the JAX package does this: its
``physics/solver.py::constraint_force`` forms a dense ``A`` and loops over
rows and sweeps with ``jax.lax.fori_loop``, which XLA compiles into one
device loop.  Eager PyTorch would launch a few kernels per row update
(tens of thousands per solve) and write ``A`` for every row, active or
not, so it is one kernel here: ``csrc/pgs_solve.cu``, built for ``sm_90a``
at first use with ``torch.utils.cpp_extension.load`` into
``envpool_tpu_torch/_build/pgs_solve/`` and called through its plain C
interface with ``ctypes``.

:data:`pgs_solve` takes the rows ``J [N, nr, nv]``, the Cholesky factor
``L [N, nv, nv]`` of ``M`` with ``ok [N]`` (bool: the factor exists),
``qacc_smooth [N, nv]``, ``aref``, ``R`` ``[N, nr]`` (float32 or float64)
and ``active [N, nr]`` bool, and returns ``(f [N, nr], qfrc [N, nv])``:
the forces after ``iterations`` sweeps from 0 (0 on inactive rows) and
``qfrc = Jᵀf``.  Where ``ok`` is false, ``qfrc`` and the active rows'
``f`` are NaN.  On CPU tensors it runs :func:`pgs_solve_plain`; on CUDA
tensors it launches the kernel, and any build or launch error
propagates.  ``pgs_solve.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import pathlib
import time

import torch

__all__ = ["PgsSolve", "pgs_form", "pgs_plain", "pgs_solve", "pgs_solve_plain"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "pgs_solve.cu"
_BUILD_DIR = _PKG / "_build" / "pgs_solve"
_CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
_DTYPES = (torch.float32, torch.float64)
_MINVAL = 1e-10


def pgs_form(J, L, ok, qacc_smooth, aref, R):
    """The plain formation: ``(A [N, nr, nr], b, diag)`` with
    ``A = J M⁻¹ Jᵀ`` from ``M``'s factor (NaN where ``ok`` is false),
    ``b = J qacc_smooth − aref`` and ``diag = A_ii + R_i`` (at least
    1e-10)."""
    minv_jt = torch.cholesky_solve(J.transpose(1, 2), L)
    minv_jt = torch.where(ok[:, None, None], minv_jt, torch.nan)
    A = J @ minv_jt
    b = (J @ qacc_smooth[..., None]).squeeze(-1) - aref
    diag = torch.clamp_min(torch.diagonal(A, dim1=-2, dim2=-1) + R, _MINVAL)
    return A, b, diag


def pgs_plain(A, b, R, diag, active, iterations: int) -> torch.Tensor:
    """The plain sweeps: the JAX loop, vectorised over envs, a Python loop
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


def pgs_solve_plain(J, L, ok, qacc_smooth, aref, R, active, iterations: int):
    """The plain version of the kernel, with its signature:
    :func:`pgs_form`, :func:`pgs_plain`, then ``Jᵀf``."""
    A, b, diag = pgs_form(J, L, ok, qacc_smooth, aref, R)
    f = pgs_plain(A, b, R, diag, active, iterations).masked_fill(~active, 0.0)
    qfrc = (J.transpose(1, 2) @ f[..., None]).squeeze(-1)
    return f, torch.where(ok[:, None], qfrc, torch.nan)


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
                fn.argtypes = [ptr] * 11 + [i32] * 4 + [ptr]
                fn.restype = i32
            lib.pgs_solve_occupancy.argtypes = [i32, i32, ptr]
            lib.pgs_solve_occupancy.restype = i32
            lib.pgs_chase_launch.argtypes = [ptr, i32, i32, i32, ptr]
            lib.pgs_chase_launch.restype = i32
            lib.pgs_solve_error_string.argtypes = [i32]
            lib.pgs_solve_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _raise(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self._library().pgs_solve_error_string(rc).decode()
            raise RuntimeError(f"{what} kernel launch failed: {msg}")

    @staticmethod
    def _check(J, L, ok, qacc_smooth, aref, R, active) -> None:
        if J.ndim != 3:
            raise ValueError(f"pgs_solve wants J [N, nr, nv], got {tuple(J.shape)}")
        if J.dtype not in _DTYPES:
            raise TypeError(f"pgs_solve wants float32 or float64, got {J.dtype}")
        n, nr, nv = J.shape
        want = {"L": ((n, nv, nv), J.dtype), "ok": ((n,), torch.bool),
                "qacc_smooth": ((n, nv), J.dtype), "aref": ((n, nr), J.dtype),
                "R": ((n, nr), J.dtype), "active": ((n, nr), torch.bool)}
        for name, t in zip(want, (L, ok, qacc_smooth, aref, R, active)):
            shape, dtype = want[name]
            if tuple(t.shape) != shape or t.dtype != dtype or t.device != J.device:
                raise ValueError(
                    f"pgs_solve: {name} must be {list(shape)} {dtype} on {J.device}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")

    def __call__(self, J, L, ok, qacc_smooth, aref, R, active, iterations: int):
        """``(f [N, nr], qfrc [N, nv])`` after ``iterations`` projected
        Gauss–Seidel sweeps."""
        self._check(J, L, ok, qacc_smooth, aref, R, active)
        if J.device.type == "cpu":
            return pgs_solve_plain(J, L, ok, qacc_smooth, aref, R, active, iterations)
        if J.device.type != "cuda":
            raise ValueError(f"pgs_solve: no kernel for {J.device}")
        n, nr, nv = J.shape
        lib = self._library()
        # The kernel reads L column by column: L.mT row-major, which is how
        # cholesky_ex lays L out, so no copy on the main path.
        J, Lt, ok, qacc_smooth, aref, R, active = (
            t.contiguous() for t in (J, L.mT, ok, qacc_smooth, aref, R, active))
        f = torch.empty_like(aref)
        qfrc = torch.empty_like(qacc_smooth)
        if n == 0:
            return f, qfrc
        ws_idx = torch.empty(n, nr, dtype=torch.int32, device=J.device)
        ws = torch.empty(n, nr * (nv + 3), dtype=J.dtype, device=J.device)
        launch = (lib.pgs_solve_launch_f32 if J.dtype == torch.float32
                  else lib.pgs_solve_launch_f64)
        with torch.cuda.device(J.device):
            stream = torch.cuda.current_stream(J.device).cuda_stream
            rc = launch(*(t.data_ptr() for t in (J, Lt, ok, qacc_smooth, aref, R, active,
                                                  f, qfrc, ws_idx, ws)),
                        n, nr, nv, int(iterations), stream)
        self._raise(rc, "pgs_solve")
        self.launches += 1
        return f, qfrc

    def occupancy(self, n: int, nv: int, dtype=torch.float32, device="cuda") -> dict:
        """What the runtime reports for ``n`` envs of ``nv`` dofs:
        blocks and envs resident per SM, SMs, shared memory per block, the
        waves the launch takes, and the most active rows an env keeps in
        registers and shared memory (an env with more, and the three others
        of its warp, take the device-memory path, as does every env of a
        model whose ``L`` and block of ``A`` do not fit a block's shared
        memory)."""
        lib = self._library()
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(device):
            rc = lib.pgs_solve_occupancy(int(nv), int(dtype == torch.float64), out)
        self._raise(rc, "pgs_solve_occupancy")
        blocks_per_sm, sms, per_block, smem, rows = out
        blocks = -(-n // per_block)
        return {"blocks_per_sm": blocks_per_sm, "envs_per_sm": blocks_per_sm * per_block,
                "sms": sms, "smem_per_block": smem,
                "waves": -(-blocks // max(1, blocks_per_sm * sms)), "resident_rows": rows}

    CHASES = ("warp_sum", "fma_max")

    def chase(self, iters: int, kind: str = "fma_max", dtype=torch.float32,
              device="cuda") -> torch.Tensor:
        """One warp's chain of ``iters`` dependent steps in ``dtype`` (a
        test entry; not counted in ``launches``): ``"fma_max"``, an FMA and
        a max, the least a row update needs; ``"warp_sum"``, a warp-wide
        sum (the step of the earlier one-warp-per-env kernel).  ``[2]``
        int64 on the card: the SM clocks the chain took and where it
        ended."""
        lib = self._library()
        out = torch.zeros(2, dtype=torch.int64, device=device)
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            rc = lib.pgs_chase_launch(out.data_ptr(), int(iters), int(dtype == torch.float64),
                                      self.CHASES.index(kind), stream)
        self._raise(rc, "pgs_chase")
        return out


pgs_solve = PgsSolve()
