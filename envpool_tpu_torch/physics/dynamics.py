"""Articulated rigid-body dynamics in closed form, batched over envs.

Counterpart of the einsum path of ``envpool_tpu/physics/dynamics.py``:

    M(q) qdd = τ_applied + τ_passive + τ_contact − c(q, qd)

One tree pass (``kinematics.fk_dof``) emits every dof's world-frame screw;
with the static masks of ``structure.dof_structure`` the Jacobians, the
velocities, the bias accelerations (MuJoCo's RNE terms, by the product
rule through the screws' time derivatives), the mass matrix, the penalty
contacts against the ground plane, MuJoCo's inertia-box fluid drag, the
fixed tendons' springs and dampers, the actuators (joint and fixed-tendon
transmissions, affine-bias servos), the limit penalty of the limited
spatial tendons and the body-body contact pairs are closed-form batched
products over ``[N, ...]`` tensors: the servos, tendons and pairs are
gathered and reduced over their count, with no Python loop over them.
Euler with implicit damping and RK4 integrate.

With ``ContactParams(solver="mujoco")`` (the configs' ``contact_solver``)
the ground contacts and the joint limits are MuJoCo's soft constraints
instead of penalty springs, solved by projected Gauss–Seidel
(``physics/solver.py``); pairs and spatial tendons keep their penalties.
The JAX package's lane-parallel scalar backend (``physics/scalar.py``)
and its ``custom_vmap`` dispatch are a TPU layout and are not ported.

Matmuls run in full float32: :func:`step` turns TF32 off while it runs, as
the JAX code forces float32 matmul precision in its step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.batched import full_fp32
from .kinematics import _mv, fk, fk_dof, integrate_qpos, model_tensors
from .linalg import spd_solve
from .model import PhysModel
from .solver import _solver_tensors, constraint_force

__all__ = [
    "ContactParams",
    "body_com_positions",
    "body_positions",
    "bias_forces",
    "contact_depths",
    "forward",
    "full_fp32",
    "mass_matrix",
    "pair_forces",
    "site_positions",
    "step",
    "switch_sides",
]

_KLIM = 300.0  # soft joint-limit stiffness (dynamics.py::_passive_forces)


class ContactParams(NamedTuple):
    """Penalty-contact constants (per model, tunable)."""

    kp: float = 1.0e4    # normal stiffness
    kd: float = 1.0e2    # normal damping
    mu_scale: float = 1.0  # scales geom friction
    vs: float = 0.05     # friction velocity smoothing (m/s)
    ten_kp: float = 2.0e3  # spatial-tendon limit penalty stiffness
    ten_kd: float = 2.0e1  # spatial-tendon limit penalty damping
    pairs: bool = False  # body-body contacts (model.pair_*)
    pair_kp: float = 1.0e4
    pair_kd: float = 1.0e2
    solver: str = "penalty"  # "mujoco": the constraint solver (physics/solver.py)
    sol_iters: int = 40


def _use_solver(contact: ContactParams) -> bool:
    return contact.solver == "mujoco"


def site_positions(model: PhysModel, q: torch.Tensor) -> torch.Tensor:
    """World positions of all sites: ``[N, ns, 3]``."""
    Rs, ps = fk(model, q)
    mt = model_tensors(model, q.device, q.dtype)
    sb = mt.site_body
    return ps[:, sb] + torch.einsum("nsij,sj->nsi", Rs[:, sb], mt.site_pos)


def body_positions(model: PhysModel, q: torch.Tensor) -> torch.Tensor:
    """World positions of body frame origins: ``[N, nb, 3]``."""
    return fk(model, q)[1]


def body_com_positions(model: PhysModel, q: torch.Tensor) -> torch.Tensor:
    """World positions of the bodies' centres of mass (MuJoCo's ``xipos``):
    ``[N, nb, 3]``."""
    Rs, ps = fk(model, q)
    mt = model_tensors(model, q.device, q.dtype)
    return ps + torch.einsum("nbij,bj->nbi", Rs, mt.body_ipos)


def _contact_points(mt, Rs, ps):
    """World positions of the contact spheres' centers: ``[N, nc, 3]``."""
    cb = mt.con_body
    return ps[:, cb] + torch.einsum("ncij,cj->nci", Rs[:, cb], mt.con_pos)


def contact_depths(model: PhysModel, q: torch.Tensor) -> torch.Tensor:
    """Penetration of every contact sphere into the ground: ``[N, nc]``
    (positive while in contact)."""
    mt = model_tensors(model, q.device, q.dtype)
    return mt.con_radius - _contact_points(mt, *fk(model, q))[..., 2]


def _points_in_bodies(Rs, ps, bodies, local):
    """World positions ``[N, K, 3]`` of points fixed at ``local`` ``[K, 3]``
    in the frames of ``bodies`` ``[K]``."""
    return ps[:, bodies] + _mv(Rs[:, bodies], local)


def _tendon_geometry(mt, Rs, ps):
    """The limited spatial tendons (site to site): both ends ``[N, 2T, 3]``
    (ends a, then ends b), the unit direction from b to a ``[N, T, 3]``,
    and how far each length lies above and below its range ``[N, T]``."""
    x = _points_in_bodies(Rs, ps, mt.ten_body, mt.ten_local)
    n_ten = mt.ten_lo.shape[0]
    diff = x[:, :n_ten] - x[:, n_ten:]
    length = torch.linalg.vector_norm(diff, dim=-1) + 1e-9
    over = torch.clamp_min(length - mt.ten_hi, 0.0)
    under = torch.clamp_min(mt.ten_lo - length, 0.0)
    return x, diff / length[..., None], over, under


def _seg_closest(p1, q1, p2, q2):
    """Closest points between the segments ``[p1, q1]`` and ``[p2, q2]``
    (Ericson 5.1.9; ``[..., 3]`` each), and the three branch tests whose
    sides pick the formula: ``(denom > 1e-12, t < 0, t > 1)``."""

    def dot(u, v):
        return (u * v).sum(-1)

    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = dot(d1, d1) + 1e-12
    e = dot(d2, d2) + 1e-12
    f = dot(d2, r)
    c = dot(d1, r)
    b = dot(d1, d2)
    denom = a * e - b * b
    general = denom > 1e-12
    s = torch.where(general, torch.clamp((b * f - c * e) / denom, 0.0, 1.0), 0.0)
    t = (b * s + f) / e
    below, above = t < 0.0, t > 1.0
    s = torch.where(
        below,
        torch.clamp(-c / a, 0.0, 1.0),
        torch.where(above, torch.clamp((b - c) / a, 0.0, 1.0), s),
    )
    t = torch.clamp(t, 0.0, 1.0)
    return p1 + s[..., None] * d1, p2 + t[..., None] * d2, (general, below, above)


def _pair_geometry(mt, Rs, ps):
    """The body-body contact pairs (sphere or capsule segments): the
    closest points ``[N, 2P, 3]`` (on side a, then on side b), the unit
    normal from b to a ``[N, P, 3]``, the penetration ``[N, P]`` (> 0 in
    contact) and :func:`_seg_closest`'s branch tests."""
    n_pair = mt.pair_radius.shape[0]
    local = torch.cat([mt.pair_seg[:, 0], mt.pair_seg[:, 1]])  # [2P, 2 ends, 3]
    R, p = Rs[:, mt.pair_body, None], ps[:, mt.pair_body, None]
    ends = p + (R @ local[..., None]).squeeze(-1)  # [N, 2P, 2, 3]
    pa, pb, branches = _seg_closest(
        ends[:, :n_pair, 0], ends[:, :n_pair, 1], ends[:, n_pair:, 0], ends[:, n_pair:, 1]
    )
    delta = pa - pb
    dist = torch.linalg.vector_norm(delta, dim=-1) + 1e-9
    return torch.cat([pa, pb], 1), delta / dist[..., None], mt.pair_radius - dist, branches


def switch_sides(
    model: PhysModel, q: torch.Tensor, contact: ContactParams = ContactParams()
) -> torch.Tensor:
    """On which side of every switch of the penalty forces each env lies:
    ``[N, nc + 2·nj + 2·T + 4·P]`` bools.  In this order: a contact sphere
    in the ground (depth > 0), a hinge or slide joint below and above its
    range, a limited spatial tendon above and below its range, and, with
    ``contact.pairs``, a pair in contact (depth > 0) and the three branch
    tests of its closest points (:func:`_seg_closest`).  The forces jump
    where one flips, so two float32 runs of one step that put an env on
    different sides of a switch in a substep may part by far more than
    rounding."""
    mt = model_tensors(model, q.device, q.dtype)
    Rs, ps = fk(model, q)
    qs = q[:, mt.hs_qadr]
    depth = mt.con_radius - _contact_points(mt, Rs, ps)[..., 2]
    if _use_solver(contact):
        # The solver's rows switch on at their margins instead.
        st = _solver_tensors(model, q.device, q.dtype)
        sides = [-depth < st.con_margin, qs - mt.hs_lo < st.lim_margin,
                 mt.hs_hi - qs < st.lim_margin]
    else:
        sides = [depth > 0, qs < mt.hs_lo, qs > mt.hs_hi]
    if mt.ten_lo.shape[0]:
        _, _, over, under = _tendon_geometry(mt, Rs, ps)
        sides += [over > 0, under > 0]
    if contact.pairs and mt.pair_radius.shape[0]:
        _, _, pen, branches = _pair_geometry(mt, Rs, ps)
        sides += [pen > 0, *branches]
    return torch.cat(sides, 1)


class _Kin(NamedTuple):
    """Everything the dynamics needs from one tree pass."""

    Rs: torch.Tensor       # [N, nb, 3, 3]
    ps: torch.Tensor       # [N, nb, 3]
    t: torch.Tensor        # [N, nv, 3] screw linear directions
    w: torch.Tensor        # [N, nv, 3] screw rotation axes
    c: torch.Tensor        # [N, nv, 3] screw anchors
    x_com: torch.Tensor    # [N, nb, 3] world CoM positions
    centers: torch.Tensor  # [N, nc, 3] contact sphere centers


def _kin(model: PhysModel, q: torch.Tensor) -> _Kin:
    mt = model_tensors(model, q.device, q.dtype)
    Rs, ps, t, w, c = fk_dof(model, q)
    x_com = ps + torch.einsum("nbij,bj->nbi", Rs, mt.body_ipos)
    return _Kin(Rs, ps, t, w, c, x_com, _contact_points(mt, Rs, ps))


def _point_vel(mask_T, tv, wv, wxc, x):
    """Velocity of mask-selected material points ``x`` ``[N, m, 3]``.

    v(x) = maskᵀ tv + (maskᵀ wv) × x − maskᵀ (wv × c)
    (every point's mask selects a single kinematic chain).
    """
    om = mask_T @ wv
    return mask_T @ tv + torch.linalg.cross(om, x) - mask_T @ wxc, om


def _vel_from_kin(mt, k: _Kin, qd):
    """Every velocity-level quantity of one tree pass: ``(v_com [N, nb, 3],
    ω [N, nb, 3], v_con [N, nc, 3])``, the velocities of the body CoMs,
    the bodies' angular velocities and those of the contact sphere
    centres, each linear in qd (JAX's ``_vel_observables``)."""
    tv = qd[..., None] * k.t
    wv = qd[..., None] * k.w
    wxc = torch.linalg.cross(wv, k.c)
    v_com, omega = _point_vel(mt.body_mask_T, tv, wv, wxc, k.x_com)
    v_con, _ = _point_vel(mt.con_mask_T, tv, wv, wxc, k.centers)
    return v_com, omega, v_con


def _jac_from_kin(mt, k: _Kin):
    """Jacobians of (CoM velocity, ω, contact velocity) with respect to qd:
    ``Jp, Jr [N, nv, nb, 3]`` and ``Jc [N, nv, nc, 3]``."""
    Mf = mt.body_mask[None, :, :, None]
    tk, wk = k.t[:, :, None, :], k.w[:, :, None, :]
    rel = k.x_com[:, None] - k.c[:, :, None]
    Jp = Mf * (tk + torch.linalg.cross(wk, rel))
    Jr = Mf * wk.expand_as(rel)
    relc = k.centers[:, None] - k.c[:, :, None]
    Jc = mt.con_mask[None, :, :, None] * (tk + torch.linalg.cross(wk, relc))
    return Jp, Jr, Jc


def _world_inertia(mt, Rs):
    """Body inertia tensors in the world frame: ``[N, nb, 3, 3]``."""
    Rw = Rs @ mt.inertia_rot
    return torch.einsum("nbij,bj,nbkj->nbik", Rw, mt.body_inertia, Rw)


def _mass_from_jac(mt, Jp, Jr, Iw):
    M = torch.einsum("b,nibk,njbk->nij", mt.body_mass, Jp, Jp)
    M = M + torch.einsum("nibk,nbkl,njbl->nij", Jr, Iw, Jr)
    return M + torch.diag(mt.dof_armature)


def mass_matrix(model: PhysModel, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia matrices ``[N, nv, nv]`` (with armature)."""
    mt = model_tensors(model, q.device, q.dtype)
    k = _kin(model, q)
    Jp, Jr, _ = _jac_from_kin(mt, k)
    return _mass_from_jac(mt, Jp, Jr, _world_inertia(mt, k.Rs))


def _bias_accels(mt, k: _Kin, qd):
    """Body CoM accelerations and ω̇ at qdd = 0 (the RNE velocity products).

    With qd fixed: ṫ = ω_pre × t, ẇ = ω_pre × w, ċ = v_pre(c), where
    ω_pre / v_pre sum strictly preceding dofs (precedence mask), and
    a(x) = Σ_k M[k,b] qd_k [ṫ_k + ẇ_k × (x − c_k) + w_k × (v(x) − ċ_k)].
    """
    cross = torch.linalg.cross
    Mf_T, P_T = mt.body_mask_T, mt.prec_T
    tv = qd[..., None] * k.t
    wv = qd[..., None] * k.w
    wxc = cross(wv, k.c)
    v_com, omega = _point_vel(Mf_T, tv, wv, wxc, k.x_com)
    omega_pre = P_T @ wv
    vc = P_T @ tv + cross(omega_pre, k.c) - P_T @ wxc
    tdv = cross(omega_pre, tv)
    wdv = cross(omega_pre, wv)
    omega_dot = Mf_T @ wdv
    a_com = (
        Mf_T @ tdv
        + cross(omega_dot, k.x_com)
        - Mf_T @ cross(wdv, k.c)
        + cross(omega, v_com)
        - Mf_T @ cross(wv, vc)
    )
    return v_com, omega, a_com, omega_dot


def _body_wrench_tau(f, t, Jp, Jr):
    """Generalized force of world-frame forces ``f`` at the body CoMs and
    torques ``t`` on the bodies, ``[N, nb, 3]`` each: ``Jpᵀ f + Jrᵀ t``."""
    return torch.einsum("nbk,nibk->ni", f, Jp) + torch.einsum(
        "nbk,nibk->ni", t, Jr
    )


def _bias_from_accels(mt, a_com, omega, omega_dot, Iw, Jp, Jr):
    f = mt.body_mass[:, None] * (a_com - mt.gravity)
    Iom = torch.einsum("nbij,nbj->nbi", Iw, omega)
    t = torch.einsum("nbij,nbj->nbi", Iw, omega_dot) + torch.linalg.cross(
        omega, Iom
    )
    return _body_wrench_tau(f, t, Jp, Jr)


def bias_forces(
    model: PhysModel, q: torch.Tensor, qd: torch.Tensor
) -> torch.Tensor:
    """c(q, qd): Coriolis, centrifugal and gravity forces, ``[N, nv]``."""
    mt = model_tensors(model, q.device, q.dtype)
    k = _kin(model, q)
    _, omega, a_com, omega_dot = _bias_accels(mt, k, qd)
    Jp, Jr, _ = _jac_from_kin(mt, k)
    Iw = _world_inertia(mt, k.Rs)
    return _bias_from_accels(mt, a_com, omega, omega_dot, Iw, Jp, Jr)


def _contact_forces_shared(mt, params: ContactParams, centers, v_con, Jc):
    """Generalized force of the ground-plane penalty springs, and the
    velocity derivative ``−∂τ/∂qd`` of the contact model (normal damping
    ``kd`` plus the friction slope ``μ·fn/vs``) in joint space, which the
    Euler step folds into its implicit left-hand side."""
    pen = mt.con_radius - centers[..., 2]  # > 0: penetrating
    active = pen > 0
    fn = torch.where(active, params.kp * pen - params.kd * v_con[..., 2], 0.0)
    fn = torch.clamp_min(fn, 0.0)
    # Smooth Coulomb friction on the tangential velocity.
    vt = v_con[..., :2]
    mu = mt.con_friction * params.mu_scale
    vt_norm = torch.linalg.vector_norm(vt, dim=-1)
    scale = torch.tanh(vt_norm / params.vs)
    vt_dir = vt / (vt_norm[..., None] + 1e-9)
    ft = -(mu * fn * scale)[..., None] * vt_dir
    forces = torch.cat([ft, fn[..., None]], -1)  # [N, nc, 3]
    w_t = mu * fn / params.vs
    w_n = torch.where(active, params.kd, 0.0)
    w = torch.stack([w_t, w_t, w_n], -1)
    d_con = torch.einsum("nick,nck,njck->nij", Jc, w, Jc)
    return torch.einsum("nck,nick->ni", forces, Jc), d_con


def _fluid_forces(mt, v_com, omega, Rs):
    """MuJoCo's legacy inertia-box fluid drag (``engine_passive.c``).

    Each body is its equivalent inertia box; quadratic density drag and
    linear viscous drag act on the body's 6D velocity at its CoM in the
    inertial frame.  Returns the world-frame force and torque on every
    body, ``([N, nb, 3], [N, nb, 3])``.
    """
    Ri = Rs @ mt.inertia_rot  # the inertial frames in the world
    lin = torch.einsum("nbji,nbj->nbi", Ri, v_com)
    ang = torch.einsum("nbji,nbj->nbi", Ri, omega)
    f = -mt.fluid_lin[:, None] * lin - mt.fluid_lin2 * lin.abs() * lin
    t = -mt.fluid_ang[:, None] * ang - mt.fluid_ang2 * ang.abs() * ang
    return _mv(Ri, f), _mv(Ri, t)


def _passive_forces(mt, q, qd, limit_penalty: bool = True):
    """Joint springs, the soft joint-limit penalty (damping implicit) and
    the fixed tendons' springs and dampers (explicit, as in the JAX step).
    ``limit_penalty=False`` (solver mode) drops the limit penalty: the
    limits are constraint rows there."""
    qs = q[:, mt.hs_qadr]
    spring = -mt.hs_stiffness * (qs - mt.hs_springref)
    if limit_penalty:
        below = torch.clamp_max(qs - mt.hs_lo, 0.0)
        above = torch.clamp_min(qs - mt.hs_hi, 0.0)
        spring = spring - _KLIM * (below + above)
    tau = q.new_zeros(q.shape[0], mt.dof_damping.shape[0]).index_add_(
        1, mt.hs_dadr, spring
    )
    if len(mt.ten_stiffness):
        length = q @ mt.ten_qcoef.T
        f = -mt.ten_stiffness * (length - mt.ten_springlen)
        f = f - mt.ten_damping * (qd @ mt.ten_dcoef.T)
        tau = tau + f @ mt.ten_dcoef
    return tau


def _limit_violation(mt, q):
    """Per dof, 1 where its joint is outside its range, else 0."""
    qs = q[:, mt.hs_qadr]
    out = ((qs < mt.hs_lo) | (qs > mt.hs_hi)).to(q.dtype)
    return q.new_zeros(q.shape[0], mt.dof_damping.shape[0]).index_copy_(
        1, mt.hs_dadr, out
    )


def _actuator_forces(mt, ctrl, q, qd):
    """τ of the actuators: ``clip(ctrl)`` through the moment rows (gear ·
    gain per dof, a fixed tendon's coefficients for a tendon
    transmission), and for the affine-bias servos ``gain·clip(ctrl) +
    b1·length + b2·velocity`` through their transmission rows, recomputed
    at every substep and RK4 stage."""
    c = torch.clamp(ctrl, mt.act_lo, mt.act_hi)
    tau = c @ mt.act_moment
    if mt.aff_act.shape[0]:
        f = (
            mt.aff_gain * c[:, mt.aff_act]
            + mt.aff_b1 * (q @ mt.aff_qcoef.T)
            + mt.aff_b2 * (qd @ mt.aff_dcoef.T)
        )
        tau = tau + f @ mt.aff_dcoef
    return tau


def _point_forces_tau(mask_T, k: _Kin, x, F):
    """Generalized force of world-frame forces ``F`` at material points
    ``x`` (``[N, K, 3]`` each; point i fixed in the body whose dof mask is
    ``mask_T[i]``): ``Σ_i mask_T[i, k] (t_k + w_k × (x_i − c_k)) · F_i``,
    ``[N, nv]``."""
    jp = k.t[:, :, None] + torch.linalg.cross(
        k.w[:, :, None], x[:, None] - k.c[:, :, None], dim=-1
    )  # [N, nv, K, 3]
    return ((jp * F[:, None]).sum(-1) * mask_T.T).sum(-1)


def _spatial_tendon_tau(mt, k: _Kin, tv, wv, wxc, contact: ContactParams):
    """The limit-range penalty of the limited spatial tendons (ball_in_cup's
    string), as the JAX step has it: outside its range a tendon pulls its
    two sites along the string with ``−ten_kp·(over − under) − ten_kd·l̇``
    (a signed force: past the lower limit it pushes); the tendons'
    stiffness and damping are not used."""
    x, u, over, under = _tendon_geometry(mt, k.Rs, k.ps)
    n_ten = u.shape[1]
    v, _ = _point_vel(mt.ten_mask_T, tv, wv, wxc, x)
    ldot = (u * (v[:, :n_ten] - v[:, n_ten:])).sum(-1)
    active = (over > 0) | (under > 0)
    f = torch.where(active, -contact.ten_kp * (over - under) - contact.ten_kd * ldot, 0.0)
    F = f[..., None] * u
    return _point_forces_tau(mt.ten_mask_T, k, x, torch.cat([F, -F], 1))


def _pair_normal(mt, x, n, pen, tv, wv, wxc, contact: ContactParams):
    """Every pair's normal force ``[N, P]`` (a one-sided spring and damper
    at the closest points), the relative velocity of side a against side b
    ``[N, P, 3]`` and its normal component ``[N, P]``."""
    v, _ = _point_vel(mt.pair_mask_T, tv, wv, wxc, x)
    n_pair = pen.shape[1]
    v_rel = v[:, :n_pair] - v[:, n_pair:]
    vn = (v_rel * n).sum(-1)
    fn = torch.where(pen > 0, contact.pair_kp * pen - contact.pair_kd * vn, 0.0)
    return torch.clamp_min(fn, 0.0), v_rel, vn


def _pair_contact_tau(mt, k: _Kin, tv, wv, wxc, contact: ContactParams):
    """The body-body pairs' penalty contacts: the normal force of
    :func:`_pair_normal` plus smooth Coulomb friction on the tangential
    relative velocity, at the closest points, on both bodies."""
    x, n, pen, _ = _pair_geometry(mt, k.Rs, k.ps)
    fn, v_rel, vn = _pair_normal(mt, x, n, pen, tv, wv, wxc, contact)
    vt = v_rel - vn[..., None] * n
    vt_norm = torch.linalg.vector_norm(vt, dim=-1) + 1e-9
    mu = mt.pair_friction * contact.mu_scale
    ft = -(mu * fn * torch.tanh(vt_norm / contact.vs))[..., None] * vt / vt_norm[..., None]
    F = fn[..., None] * n + ft
    return _point_forces_tau(mt.pair_mask_T, k, x, torch.cat([F, -F], 1))


def pair_forces(
    model: PhysModel, q: torch.Tensor, qd: torch.Tensor, contact: ContactParams
) -> torch.Tensor:
    """Every body-body pair's penalty normal force ``[N, P]`` (JAX's
    ``_pair_fn``; finger's touch observation)."""
    mt = model_tensors(model, q.device, q.dtype)
    k = _kin(model, q)
    tv, wv = qd[..., None] * k.t, qd[..., None] * k.w
    x, n, pen, _ = _pair_geometry(mt, k.Rs, k.ps)
    return _pair_normal(mt, x, n, pen, tv, wv, torch.linalg.cross(wv, k.c), contact)[0]


def _smooth(model: PhysModel, q, qd, ctrl, contact: ContactParams):
    """One shared pass: ``(M, τ, D_con, kin)`` with every force once.  In
    solver mode τ leaves out the ground contacts and the joint-limit
    penalty (the solver's rows), and ``D_con`` is None."""
    mt = model_tensors(model, q.device, q.dtype)
    use_solver = _use_solver(contact)
    k = _kin(model, q)
    Iw = _world_inertia(mt, k.Rs)
    Jp, Jr, Jc = _jac_from_kin(mt, k)
    v_com, omega, a_com, omega_dot = _bias_accels(mt, k, qd)
    M = _mass_from_jac(mt, Jp, Jr, Iw)
    c = _bias_from_accels(mt, a_com, omega, omega_dot, Iw, Jp, Jr)
    tv = qd[..., None] * k.t
    wv = qd[..., None] * k.w
    wxc = torch.linalg.cross(wv, k.c)
    tau_con, d_con = 0.0, None
    if not use_solver:
        v_con, _ = _point_vel(mt.con_mask_T, tv, wv, wxc, k.centers)
        tau_con, d_con = _contact_forces_shared(mt, contact, k.centers, v_con, Jc)
    tau = (
        _actuator_forces(mt, ctrl, q, qd)
        + _passive_forces(mt, q, qd, limit_penalty=not use_solver)
        + tau_con
        - c
        - mt.dof_damping * qd
    )
    if model.density > 0 or model.viscosity > 0:
        f, t = _fluid_forces(mt, v_com, omega, k.Rs)
        tau = tau + _body_wrench_tau(f, t, Jp, Jr)
    # Explicit in the Euler step, as in the JAX step (not in D_con).
    if mt.ten_lo.shape[0]:
        tau = tau + _spatial_tendon_tau(mt, k, tv, wv, wxc, contact)
    if contact.pairs and mt.pair_radius.shape[0]:
        tau = tau + _pair_contact_tau(mt, k, tv, wv, wxc, contact)
    return M, tau, d_con, k


def forward(
    model: PhysModel,
    q: torch.Tensor,
    qd: torch.Tensor,
    ctrl: torch.Tensor,
    contact: ContactParams = ContactParams(),
) -> torch.Tensor:
    """Forward dynamics: qacc ``[N, nv]`` with explicit damping (for RK4).
    The constraint solver works at the model's timestep here, as in the
    JAX step, whatever the substep."""
    M, tau, _, k = _smooth(model, q, qd, ctrl, contact)
    if _use_solver(contact):
        qfrc_con, qacc_smooth = constraint_force(
            model, k, q, qd, M, tau, model.timestep, contact.sol_iters
        )
        return qacc_smooth + spd_solve(M, qfrc_con)
    return spd_solve(M, tau)


def _euler(model, q, qd, ctrl, contact, h):
    """Euler with implicit damping: ``(M + h·D) qacc = τ − d_lim·qd``.

    The joint-limit penalty is critically damped against the dof's own
    inertia while violated, and the contact damping ``D_con`` joins the
    left-hand side, as in the JAX step.
    """
    mt = model_tensors(model, q.device, q.dtype)
    M, tau, d_con, k = _smooth(model, q, qd, ctrl, contact)
    if _use_solver(contact):
        # mj_Euler: the solver's forces against plain M at the substep,
        # then (M + h·diag(damping)) qacc = τ + Jᵀf.
        qfrc_con, _ = constraint_force(model, k, q, qd, M, tau, h, contact.sol_iters)
        qacc = spd_solve(M + h * torch.diag(mt.dof_damping), tau + qfrc_con)
        qd_new = qd + h * qacc
        return integrate_qpos(model, q, qd_new, h), qd_new
    diag_M = torch.diagonal(M, dim1=-2, dim2=-1)
    d_lim = 2.0 * torch.sqrt(_KLIM * diag_M) * _limit_violation(mt, q)
    M_imp = M + h * (torch.diag_embed(mt.dof_damping + d_lim) + d_con)
    qacc = spd_solve(M_imp, tau - d_lim * qd)
    qd_new = qd + h * qacc
    return integrate_qpos(model, q, qd_new, h), qd_new


def _rk4(model, q, qd, ctrl, contact, h):
    a1 = forward(model, q, qd, ctrl, contact)
    q2 = integrate_qpos(model, q, qd, h / 2)
    qd2 = qd + (h / 2) * a1
    a2 = forward(model, q2, qd2, ctrl, contact)
    q3 = integrate_qpos(model, q, qd2, h / 2)
    qd3 = qd + (h / 2) * a2
    a3 = forward(model, q3, qd3, ctrl, contact)
    q4 = integrate_qpos(model, q, qd3, h)
    qd4 = qd + h * a3
    a4 = forward(model, q4, qd4, ctrl, contact)
    qd_avg = (qd + 2 * qd2 + 2 * qd3 + qd4) / 6
    qacc = (a1 + 2 * a2 + 2 * a3 + a4) / 6
    return integrate_qpos(model, q, qd_avg, h), qd + h * qacc


def step(
    model: PhysModel,
    qpos: torch.Tensor,
    qvel: torch.Tensor,
    ctrl: torch.Tensor,
    substeps: int = 1,
    contact: ContactParams = ContactParams(),
    nsteps: int = 1,
):
    """Advance every env ``nsteps`` model timesteps of ``substeps`` each.

    The model's integrator picks Euler with implicit damping (MuJoCo's
    ``mj_Euler``, integrator 0) or RK4 (``mj_RungeKutta``, 1).  ``nsteps``
    is the frame-skip loop; ``substeps`` splits the timestep for
    penalty-contact stability.  Returns ``(qpos, qvel)``, both ``[N, ·]``.
    """
    h = model.timestep / substeps
    stepper = _rk4 if model.integrator == 1 else _euler
    with full_fp32():
        for _ in range(nsteps * substeps):
            qpos, qvel = stepper(model, qpos, qvel, ctrl, contact, h)
    return qpos, qvel
