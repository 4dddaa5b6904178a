"""Batched SPD solves for the joint-space inertia matrices.

Counterpart of ``envpool_tpu/physics/linalg.py``.  The JAX version unrolls
a Cholesky into a chain of elementwise ops over one env's matrix and clamps
each pivot at 1e-12, so it never stops.  Unrolled over ``[N]`` tensors here
that chain would be ~400 launches per solve; the library's batched Cholesky
factor-and-solve over ``[N, n, n]`` is a few.

On a matrix that is not SPD the factorisation stops (``info > 0``) and the
port returns NaN for that row, where the JAX version returns the
meaningless (huge or infinite) solution of its clamped factor.  The check stays on the device:
nothing waits for ``info`` on the host.
"""

from __future__ import annotations

import torch

__all__ = ["factor_solve", "spd_factor", "spd_solve"]


def spd_factor(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(L, ok)``: the lower Cholesky factor of each ``M [N, n, n]`` and
    whether it exists (``ok [N]`` bool; where it is false, ``L`` is
    meaningless)."""
    L, info = torch.linalg.cholesky_ex(M)
    return L, info == 0


def spd_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``M x = b`` row by row: ``M`` is ``[N, n, n]``, ``b`` ``[N, n]``
    or, for several right-hand sides at once, ``[N, n, k]``.

    Rows whose ``M`` is not SPD come out as NaN.
    """
    return factor_solve(*spd_factor(M), b)


def factor_solve(L: torch.Tensor, ok: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`spd_solve` from ``spd_factor``'s ``(L, ok)``."""
    vector = b.dim() == L.dim() - 1
    rhs = b.unsqueeze(-1) if vector else b
    x = torch.cholesky_solve(rhs, L)
    x = torch.where(ok[..., None, None], x, torch.nan)
    return x.squeeze(-1) if vector else x
