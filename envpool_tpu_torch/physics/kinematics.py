"""Batched forward and velocity kinematics over ``[N, ...]`` tensors.

Counterpart of ``envpool_tpu/physics/kinematics.py``, whose functions take
one env's ``q`` and are ``vmap``ped.  Here ``q`` is ``[N, nq]`` and every
result carries the env axis first.  The tree loop runs over the model's
bodies in Python, as the JAX one unrolls at trace time; each joint is a
handful of batched tensor ops.

Hinge and slide joints are ported (what the Gym locomotion models without
a floating base run).  Free and ball joints raise ``NotImplementedError``.
The model's constants live on the device once per (model, device, dtype):
:func:`model_tensors`.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch

from .model import HINGE, SLIDE, PhysModel
from .structure import dof_structure

__all__ = [
    "quat2mat",
    "model_tensors",
    "fk",
    "fk_dof",
    "tangent",
    "body_vel",
    "integrate_qpos",
]


def quat2mat(q: np.ndarray) -> np.ndarray:
    """Rotation matrices ``[..., 3, 3]`` of quaternions ``[..., 4]`` (w
    first), in numpy: the port rotates by constant quaternions only."""
    w, x, y, z = (q[..., i] for i in range(4))
    rows = [
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ]
    return np.stack(rows, -1).reshape(*q.shape[:-1], 3, 3)


def _check_joints(model: PhysModel) -> None:
    kinds = {int(j) for j in model.jnt_type}
    if not kinds <= {HINGE, SLIDE}:
        raise NotImplementedError(
            "envpool_tpu_torch's physics runs hinge and slide joints only; "
            f"this model has joint types {sorted(kinds)} (0 free, 1 ball)"
        )


@functools.lru_cache(maxsize=64)
def model_tensors(
    model: PhysModel, device: torch.device, dtype: torch.dtype
) -> types.SimpleNamespace:
    """The model's constants and structure tables as tensors on ``device``.

    Rotations of constant quaternions are computed once in float64.
    """
    _check_joints(model)
    s = dof_structure(model)

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    long = torch.int64
    nu, nv = model.nu, model.nv
    moment = np.zeros((nu, nv))
    for a, row in enumerate(s.act_moments):
        for dadr, coef in row:
            moment[a, dadr] += coef
    body_mask = s.body_mask.astype(np.float64)
    con_mask = s.con_mask.astype(np.float64)
    return types.SimpleNamespace(
        eye=torch.eye(3, dtype=dtype, device=device),
        body_rot=t(quat2mat(np.asarray(model.body_quat, np.float64))),
        body_pos=t(model.body_pos),
        jnt_axis=t(model.jnt_axis),
        jnt_pos=t(model.jnt_pos),
        body_ipos=t(model.body_ipos),
        body_mass=t(model.body_mass),
        inertia_rot=t(quat2mat(np.asarray(model.body_iquat, np.float64))),
        body_inertia=t(model.body_inertia),
        gravity=t(model.gravity),
        dof_damping=t(model.dof_damping),
        dof_armature=t(model.dof_armature),
        con_body=t(model.con_body, long),
        con_pos=t(model.con_pos),
        con_radius=t(model.con_radius),
        con_friction=t(model.con_friction),
        site_body=t(model.site_body, long),
        site_pos=t(model.site_pos),
        body_mask=t(body_mask),
        body_mask_T=t(body_mask.T),
        prec_T=t(s.prec.astype(np.float64).T),
        con_mask=t(con_mask),
        con_mask_T=t(con_mask.T),
        hs_qadr=t(s.hs_qadr, long),
        hs_dadr=t(s.hs_dadr, long),
        hs_stiffness=t(s.hs_stiffness),
        hs_springref=t(s.hs_springref),
        hs_lo=t(s.hs_lo),
        hs_hi=t(s.hs_hi),
        act_lo=t(s.act_lo),
        act_hi=t(s.act_hi),
        act_moment=t(moment),
    )


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``A @ v`` over leading axes."""
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def _axis_angle(axis: torch.Tensor, angle: torch.Tensor, eye) -> torch.Tensor:
    """Rotation matrices ``[N, 3, 3]`` about unit axes ``[N, 3]`` (Rodrigues)."""
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    k = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).view(-1, 3, 3)
    return eye + s * k + (1 - c) * (k @ k)


def _joints_of_body(model: PhysModel) -> list[list[int]]:
    out: list[list[int]] = [[] for _ in range(model.nbody)]
    for j in range(len(model.jnt_type)):
        out[int(model.jnt_body[j])].append(j)
    return out


def _tree(model: PhysModel, q: torch.Tensor, screws: bool):
    """The tree pass behind :func:`fk` and :func:`fk_dof`.

    Joints of a body apply in model order within the body frame, as in
    MuJoCo's ``mj_kinematics``; hinge and slide transforms are relative to
    ``qpos0`` (the MJCF ``ref``).
    """
    mt = model_tensors(model, q.device, q.dtype)
    n = q.shape[0]
    q0 = model.qpos0
    Rs = [mt.eye.expand(n, 3, 3)]
    ps = [q.new_zeros(n, 3)]
    zero3 = q.new_zeros(n, 3)
    t = [zero3] * model.nv
    w = [zero3] * model.nv
    c = [zero3] * model.nv
    for b, joints in enumerate(_joints_of_body(model)):
        if b == 0:
            continue
        parent = int(model.body_parent[b])
        if parent == 0:  # the world frame is the identity: nothing to apply
            R = mt.body_rot[b].expand(n, 3, 3)
            p = mt.body_pos[b].expand(n, 3)
        else:
            R = Rs[parent] @ mt.body_rot[b]
            p = ps[parent] + Rs[parent] @ mt.body_pos[b]
        for j in joints:
            adr = int(model.jnt_qposadr[j])
            d = int(model.jnt_dofadr[j])
            axis_w = R @ mt.jnt_axis[j]
            angle = q[:, adr] - float(q0[adr])
            if int(model.jnt_type[j]) == SLIDE:
                t[d] = axis_w
                p = p + axis_w * angle[:, None]
            else:  # HINGE
                anchor_w = p + R @ mt.jnt_pos[j]
                w[d] = axis_w
                c[d] = anchor_w
                rot = _axis_angle(axis_w, angle, mt.eye)
                R = rot @ R
                p = anchor_w + _mv(rot, p - anchor_w)
        Rs.append(R)
        ps.append(p)
    out = (torch.stack(Rs, 1), torch.stack(ps, 1))
    if screws:
        out += (torch.stack(t, 1), torch.stack(w, 1), torch.stack(c, 1))
    return out


def fk(model: PhysModel, q: torch.Tensor):
    """Body world frames: ``(R [N, nb, 3, 3], p [N, nb, 3])``."""
    return _tree(model, q, screws=False)


def fk_dof(model: PhysModel, q: torch.Tensor):
    """One tree pass that also emits every dof's world-frame screw.

    Returns ``(Rs, ps, t [N, nv, 3], w [N, nv, 3], c [N, nv, 3])``: dof k
    moves a point x of every body it moves at ``qd_k (t_k + w_k × (x − c_k))``
    and turns it at ``qd_k w_k``.
    """
    return _tree(model, q, screws=True)


def tangent(model: PhysModel, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """Coordinate tangent q̇ of a generalized velocity (identity here)."""
    _check_joints(model)
    del q
    return qd


def body_vel(model: PhysModel, q: torch.Tensor, qd: torch.Tensor):
    """``((R, p), (ω [N, nb, 3], v [N, nb, 3]))``: world-frame body twists.

    The JAX version differentiates :func:`fk` (``jax.jvp``); here the
    screws of :func:`fk_dof` give the same velocities in closed form.
    """
    Rs, ps, t, w, c = fk_dof(model, q)
    mt = model_tensors(model, q.device, q.dtype)
    wv = qd[..., None] * w
    omega = mt.body_mask_T @ wv
    v = (
        mt.body_mask_T @ (qd[..., None] * t)
        + torch.linalg.cross(omega, ps)
        - mt.body_mask_T @ torch.linalg.cross(wv, c)
    )
    return (Rs, ps), (omega, v)


def integrate_qpos(
    model: PhysModel, q: torch.Tensor, qd: torch.Tensor, h: float
) -> torch.Tensor:
    """qpos ← qpos + h·qd (hinge and slide joints)."""
    _check_joints(model)
    return q + h * qd
