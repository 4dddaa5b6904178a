"""MuJoCo's soft constraint solver for ground contacts and joint limits,
batched over envs.

Counterpart of ``envpool_tpu/physics/solver.py`` (the opt-in
``contact_solver="mujoco"``).  Each env's rows are MuJoCo's: four pyramid
facets ``n ± μ·t₁``, ``n ± μ·t₂`` per ground-plane contact sphere and one
row per limited hinge or slide joint, with the impedance ``d(r)`` of
``solimp``, the reference acceleration ``aref = −B·(J qd) − d·K·r`` of
``solref`` and the regulariser ``R = (1 − d)/d · invweight``.  The forces
solve the regularised dual

    min_f  ½ fᵀ(A + R)f + fᵀ(J qacc_smooth − aref),   f ≥ 0,   A = J M⁻¹ Jᵀ

by ``iterations`` projected Gauss–Seidel sweeps over the rows in order.
``M`` is factored once here; ``ops.cuda_pgs.pgs_solve`` takes the rows
and the factor and does the rest: on the card a hand-written kernel forms
``A`` for each env's active rows alone and runs the sweeps and ``Jᵀf``;
on the CPU the plain route forms the dense ``A`` by one batched solve and
one batched matmul, as the JAX code does, and loops over the rows.

Rows whose distance is at or past their margin are inactive: their force
stays 0.  An unlimited joint's row has its distance set to 0, so no
infinity reaches ``aref``.  Body-body pairs and spatial tendons stay on
the penalty path (``dynamics._smooth``).
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch

from ..ops.cuda_pgs import pgs_solve
from .kinematics import model_tensors
from .linalg import factor_solve, spd_factor
from .model import PhysModel
from .structure import dof_structure

__all__ = ["constraint_force", "pgs_system", "solver_rows"]

_MINVAL = 1e-10


@functools.lru_cache(maxsize=64)
def _solver_tensors(model: PhysModel, device: torch.device, dtype: torch.dtype):
    """The rows' constants as tensors: per contact sphere and per
    hinge/slide joint (``structure.hs_*`` order)."""
    s = dof_structure(model)
    nc = len(model.con_body)

    def t(a, shape):
        if a is None or not np.asarray(a).size:
            return torch.zeros(shape, dtype=dtype, device=device)
        return torch.as_tensor(np.asarray(a, np.float64).reshape(shape), device=device).to(dtype)

    jids = np.asarray(s.hs_jnt, np.int64)
    nl = len(jids) if model.jnt_solref_lim is not None else 0

    def per_row(a, index, k):
        return t(np.asarray(a, np.float64).reshape(-1, k)[index] if nl else None, (nl, k))

    con_axis = t(model.con_axis, (nc, 3))
    return types.SimpleNamespace(
        con_margin=t(model.con_margin, (nc,)),
        con_solref=t(model.con_solref, (nc, 2)),
        con_solimp=t(model.con_solimp, (nc, 5)),
        con_invw=t(model.con_invw, (nc,)),
        con_axis=con_axis,
        has_axis=torch.linalg.vector_norm(con_axis, dim=1) > 0.5,
        n_limit=nl,
        lim_solref=per_row(model.jnt_solref_lim, jids, 2),
        lim_solimp=per_row(model.jnt_solimp_lim, jids, 5),
        lim_margin=per_row(model.jnt_margin, jids, 1)[:, 0],
        lim_invw=per_row(model.dof_invweight, s.hs_dadr, 1)[:, 0],
    )


def _impedance(solimp: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """MuJoCo's impedance ``d(r)``: ``dmin`` to ``dmax`` over
    ``|r| ∈ [0, width]`` along the two-piece power sigmoid."""
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(r.abs() / torch.clamp_min(width, _MINVAL), 0.0, 1.0)
    a = 1.0 / torch.clamp_min(mid, _MINVAL) ** (power - 1.0)
    b = 1.0 / torch.clamp_min(1.0 - mid, _MINVAL) ** (power - 1.0)
    y = torch.where(x <= mid, a * x**power, 1.0 - b * (1.0 - x) ** power)
    return torch.clamp(dmin + y * (dmax - dmin), _MINVAL, 1.0 - _MINVAL)


def _kbi(solref: torch.Tensor, solimp: torch.Tensor, h: float):
    """``(K, B)`` per row; ``solref``'s time constant clamped to at least
    ``2h`` (``mj_assignRef``)."""
    tc = torch.clamp_min(solref[..., 0], 2.0 * h)
    dr = solref[..., 1]
    dmax = solimp[..., 1]
    K = 1.0 / torch.clamp_min(dmax**2 * tc**2 * dr**2, _MINVAL)
    B = 2.0 / torch.clamp_min(dmax * tc, _MINVAL)
    return K, B


def _contact_rows(model: PhysModel, k, qd: torch.Tensor, h: float):
    """The pyramid facet rows of every ground-plane contact sphere:
    ``(J [N, 4nc, nv], aref, R, active [N, 4nc])``, contact-major."""
    mt = model_tensors(model, qd.device, qd.dtype)
    st = _solver_tensors(model, qd.device, qd.dtype)
    n, nc = qd.shape[0], mt.con_radius.shape[0]
    dist = k.centers[..., 2] - mt.con_radius  # the plane z = 0; < 0 penetrates
    active = dist < st.con_margin
    # The contact point: midway between the plane and the sphere's surface.
    x_c = torch.cat([k.centers[..., :2], (dist / 2.0)[..., None]], -1)
    relc = x_c[:, None] - k.c[:, :, None]  # [N, nv, nc, 3]
    Jpt = mt.con_mask[None, :, :, None] * (
        k.t[:, :, None] + torch.linalg.cross(k.w[:, :, None], relc)
    )
    # Tangent frame: a capsule's axis projected onto the plane, else the
    # plane's own frame t1 = (0, 1, 0), t2 = (-1, 0, 0).
    Rb = k.Rs[:, mt.con_body]  # [N, nc, 3, 3]
    axis_w = (Rb @ st.con_axis[..., None]).squeeze(-1)
    in_plane = torch.cat([axis_w[..., :2], torch.zeros_like(axis_w[..., 2:])], -1)
    nrm = torch.linalg.vector_norm(in_plane, dim=-1)
    has_axis = st.has_axis & (nrm > 1e-9)
    default_t1 = in_plane.new_tensor([0.0, 1.0, 0.0]).expand_as(in_plane)
    t1 = torch.where(has_axis[..., None], in_plane / torch.clamp_min(nrm, 1e-12)[..., None],
                     default_t1)
    t2 = torch.stack([-t1[..., 1], t1[..., 0], torch.zeros_like(t1[..., 0])], -1)
    Jn = Jpt[..., 2].transpose(1, 2)  # [N, nc, nv]
    Jt1 = torch.einsum("nvci,nci->ncv", Jpt, t1)
    Jt2 = torch.einsum("nvci,nci->ncv", Jpt, t2)
    m1 = mt.con_friction[:, None]
    J = torch.stack([Jn + m1 * Jt1, Jn - m1 * Jt1, Jn + m1 * Jt2, Jn - m1 * Jt2], 2)
    J = J.reshape(n, 4 * nc, qd.shape[1])
    r = dist - st.con_margin
    d = _impedance(st.con_solimp, r)
    K, B = _kbi(st.con_solref, st.con_solimp, h)
    vel = (J @ qd[..., None]).squeeze(-1)

    def rep(x):
        return x.repeat_interleave(4, dim=-1)

    d4 = rep(d)
    aref = -rep(B) * vel - d4 * rep(K) * rep(r)
    R = torch.clamp_min((1.0 - d4) / d4 * rep(st.con_invw), _MINVAL)
    return J, aref, R, rep(active)


def _limit_rows(model: PhysModel, q: torch.Tensor, qd: torch.Tensor, h: float):
    """One row per hinge or slide joint, active only for a limited joint
    within its margin of its nearer limit: ``(J [N, nl, nv], aref, R,
    active [N, nl])``.  ``J`` is ``+e`` at the lower limit, ``−e`` at the
    upper."""
    mt = model_tensors(model, q.device, q.dtype)
    st = _solver_tensors(model, q.device, q.dtype)
    n, nv, nl = q.shape[0], qd.shape[1], st.n_limit
    if nl == 0:
        z = q.new_zeros(n, 0)
        return q.new_zeros(n, 0, nv), z, z, z.bool()
    lo, hi = mt.hs_lo, mt.hs_hi
    limited = torch.isfinite(lo) & torch.isfinite(hi)
    qs = q[:, mt.hs_qadr]
    dist_lo = qs - lo
    dist_hi = hi - qs
    lo_side = dist_lo <= dist_hi
    dist = torch.where(lo_side, dist_lo, dist_hi)
    # Unlimited joints have ±inf bounds: their (inactive) rows get distance
    # 0, so that no inf · 0 = nan reaches aref.
    dist = torch.where(limited, dist, 0.0)
    sign = torch.where(lo_side, 1.0, -1.0).to(q.dtype)
    active = limited & (dist < st.lim_margin)
    J = q.new_zeros(n, nl, nv)
    J[:, torch.arange(nl, device=q.device), mt.hs_dadr] = sign
    r = dist - st.lim_margin
    d = _impedance(st.lim_solimp, r)
    K, B = _kbi(st.lim_solref, st.lim_solimp, h)
    vel = sign * qd[:, mt.hs_dadr]
    aref = -B * vel - d * K * r
    R = torch.clamp_min((1.0 - d) / d * st.lim_invw, _MINVAL)
    return J, aref, R, active


def solver_rows(model: PhysModel, k, q: torch.Tensor, qd: torch.Tensor, h: float):
    """Every constraint row of every env, contacts then limits:
    ``(J [N, nr, nv], aref, R, active [N, nr])``."""
    rows = [_contact_rows(model, k, qd, h), _limit_rows(model, q, qd, h)]
    return tuple(torch.cat(parts, 1) for parts in zip(*rows))


def pgs_system(model: PhysModel, k, q: torch.Tensor, qd: torch.Tensor, M: torch.Tensor,
               tau_smooth: torch.Tensor, h: float):
    """The solve's inputs, ``pgs_solve``'s arguments: ``(J, L, ok,
    qacc_smooth, aref, R, active)`` with ``L`` ``M``'s Cholesky factor,
    ``ok`` whether it exists and ``qacc_smooth = M⁻¹ tau_smooth`` (NaN
    where it does not)."""
    J, aref, R, active = solver_rows(model, k, q, qd, h)
    L, ok = spd_factor(M)
    return J, L, ok, factor_solve(L, ok, tau_smooth), aref, R, active


def constraint_force(
    model: PhysModel,
    k,
    q: torch.Tensor,
    qd: torch.Tensor,
    M: torch.Tensor,
    tau_smooth: torch.Tensor,
    h: float,
    iterations: int = 40,
):
    """``(qfrc_constraint [N, nv], qacc_smooth [N, nv])``: the joint-space
    constraint force ``Jᵀf`` of the projected Gauss–Seidel solution and
    ``M⁻¹ tau_smooth``.  ``k`` is the dynamics' tree pass at ``q``."""
    system = pgs_system(model, k, q, qd, M, tau_smooth, h)
    qacc_smooth = system[3]
    if system[0].shape[1] == 0:
        return torch.zeros_like(tau_smooth), qacc_smooth
    _, qfrc = pgs_solve(*system, iterations)
    return qfrc, qacc_smooth
