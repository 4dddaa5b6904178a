"""Batched forward and velocity kinematics over ``[N, ...]`` tensors.

Counterpart of ``envpool_tpu/physics/kinematics.py``, whose functions take
one env's ``q`` and are ``vmap``ped.  Here ``q`` is ``[N, nq]`` and every
result carries the env axis first.  The tree loop runs over the model's
bodies in Python, as the JAX one unrolls at trace time; each joint is a
handful of batched tensor ops.

Every joint type of the JAX package runs: hinge, slide, ball and free (3
world-frame translations and a quaternion whose angular velocity lives in
the body frame, MuJoCo's convention).  The model's constants live on the
device once per (model, device, dtype): :func:`model_tensors`.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch
import torch.nn.functional as F

from .model import BALL, FREE, SLIDE, PhysModel
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


def quat2mat(q):
    """Rotation matrices ``[..., 3, 3]`` of quaternions ``[..., 4]`` (w
    first), of a numpy array or a tensor."""
    stack = torch.stack if isinstance(q, torch.Tensor) else np.stack
    w, x, y, z = (q[..., i] for i in range(4))
    rows = [
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ]
    return stack(rows, -1).reshape(*q.shape[:-1], 3, 3)


def _quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton products ``a ⊗ b`` of quaternions ``[N, 4]`` (w first)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def _unit_rotation(quat: torch.Tensor) -> torch.Tensor:
    """Rotations of quaternions ``[N, 4]``, normalised first as
    ``mj_forward`` normalises qpos quaternions in place."""
    return quat2mat(quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True))


def _fluid_coefficients(model: PhysModel) -> dict[str, np.ndarray]:
    """Per-body drag coefficients of MuJoCo's inertia-box fluid model
    (``dynamics._fluid_forces``), in float64."""
    inertia = np.asarray(model.body_inertia, np.float64)
    mass = np.asarray(model.body_mass, np.float64)
    s = inertia.sum(1, keepdims=True) - 2 * inertia
    box = np.sqrt(np.maximum(1e-10, s / np.maximum(mass[:, None], 1e-12) * 6.0))
    diam = box.mean(1)
    box1, box2 = np.roll(box, -1, 1), np.roll(box, -2, 1)
    return {
        "fluid_lin": 3 * np.pi * diam * model.viscosity,
        "fluid_ang": np.pi * diam**3 * model.viscosity,
        "fluid_lin2": 0.5 * model.density * box1 * box2,
        "fluid_ang2": model.density * box * (box1**4 + box2**4) / 64.0,
    }


def _tendon_tables(model: PhysModel) -> dict[str, np.ndarray]:
    """The fixed tendons that have a spring or a damper, as coefficient
    rows over qpos ``[T, nq]`` and qvel ``[T, nv]``."""
    k, d = model.ten_fixed_stiffness, model.ten_fixed_damping
    rows = [t for t in range(len(model.ten_fixed)) if k[t] != 0 or d[t] != 0]
    qcoef = np.zeros((len(rows), model.nq))
    dcoef = np.zeros((len(rows), model.nv))
    for i, t in enumerate(rows):
        for qadr, dadr, coef in model.ten_fixed[t]:
            qcoef[i, qadr] += coef
            dcoef[i, dadr] += coef

    def pick(a):
        return np.asarray([a[t] for t in rows], np.float64)

    return {
        "ten_qcoef": qcoef,
        "ten_dcoef": dcoef,
        "ten_stiffness": pick(k),
        "ten_damping": pick(d),
        "ten_springlen": pick(model.ten_fixed_springlen),
    }


def _affine_tables(model: PhysModel, s) -> dict[str, np.ndarray]:
    """The affine-bias servos (``structure.act_affine``) as dense rows:
    actuator index, gain, ``biasprm[1:3]``, and each servo's transmission
    coefficients over qpos ``[A, nq]`` and qvel ``[A, nv]``."""
    rows = s.act_affine
    qcoef = np.zeros((len(rows), model.nq))
    dcoef = np.zeros((len(rows), model.nv))
    for i, (_, _, _, _, triples) in enumerate(rows):
        for qadr, dadr, coef in triples:
            qcoef[i, qadr] += coef
            dcoef[i, dadr] += coef
    return {
        "aff_act": np.asarray([r[0] for r in rows], np.int64),
        "aff_gain": np.asarray([r[1] for r in rows], np.float64),
        "aff_b1": np.asarray([r[2] for r in rows], np.float64),
        "aff_b2": np.asarray([r[3] for r in rows], np.float64),
        "aff_qcoef": qcoef,
        "aff_dcoef": dcoef,
    }


def _endpoint_tables(bodies, local, body_mask):
    """Two material points per row (``bodies`` ``[K, 2]``, their offsets in
    the body frames ``[K, 2, 3]``) as the tables of
    ``dynamics._point_vel`` / ``dynamics._point_forces_tau``: both ends'
    bodies ``[2K]`` (ends a, then ends b), offsets ``[2K, 3]`` and the
    transposed body-mask columns ``[2K, nv]``."""
    b = np.concatenate([bodies[:, 0], bodies[:, 1]]).astype(np.int64)
    x = np.concatenate([local[:, 0], local[:, 1]]).reshape(-1, 3)
    return b, x, body_mask[:, b].T


def _tendon_pair_tables(model: PhysModel, body_mask) -> dict[str, np.ndarray]:
    """The limited spatial tendons (the only ones that exert a force) and
    the body-body contact pairs, each row's two ends stacked."""

    def field(name, *shape, dtype=np.float64):
        v = getattr(model, name)
        return np.zeros((0, *shape), dtype) if v is None else np.asarray(v, dtype).reshape(-1, *shape)

    limited = np.flatnonzero(field("ten_spatial_limited", dtype=bool))
    ends = field("ten_spatial_sites", 2, dtype=np.int64)[limited]
    site_body = np.asarray(model.site_body, np.int64)
    site_pos = np.asarray(model.site_pos, np.float64).reshape(-1, 3)
    ten_body, ten_local, ten_mask_T = _endpoint_tables(
        site_body[ends], site_pos[ends], body_mask)
    ten_range = field("ten_spatial_range", 2)[limited]
    pairs = field("pair_body", 2, dtype=np.int64)
    pair_body, _, pair_mask_T = _endpoint_tables(pairs, np.zeros((len(pairs), 2, 3)), body_mask)
    return {
        "ten_body": ten_body, "ten_local": ten_local, "ten_mask_T": ten_mask_T,
        "ten_lo": ten_range[:, 0], "ten_hi": ten_range[:, 1],
        "pair_body": pair_body, "pair_mask_T": pair_mask_T,
        # [P, side a/b, end 0/1, 3]: each side's segment in its body frame
        "pair_seg": np.stack([field("pair_seg_a", 2, 3), field("pair_seg_b", 2, 3)], 1),
        "pair_radius": field("pair_radius", 2).sum(1),  # in float64, as JAX's ra + rb
        "pair_friction": field("pair_friction"),
    }


@functools.lru_cache(maxsize=64)
def model_tensors(
    model: PhysModel, device: torch.device, dtype: torch.dtype
) -> types.SimpleNamespace:
    """The model's constants and structure tables as tensors on ``device``.

    Rotations of constant quaternions and the drag coefficients are
    computed once in float64.
    """
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
    tables = {**_fluid_coefficients(model), **_tendon_tables(model),
              **_affine_tables(model, s), **_tendon_pair_tables(model, body_mask)}
    index = ("aff_act", "ten_body", "pair_body")  # gathered by, not multiplied
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
        nonfree_qadr=t(s.nonfree_qadr, long),
        nonfree_dadr=t(s.nonfree_dadr, long),
        **{k: t(v, long if k in index else dtype) for k, v in tables.items()},
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
    MuJoCo's ``mj_kinematics``: a hinge turns the frame about the axis
    through its anchor and a slide moves it along its axis (both relative
    to ``qpos0``, the MJCF ``ref``), a ball turns it about its anchor in the
    child frame, and a free joint sets it from qpos.
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
            kind = int(model.jnt_type[j])
            adr = int(model.jnt_qposadr[j])
            d = int(model.jnt_dofadr[j])
            if kind == FREE:
                p = q[:, adr : adr + 3]
                R = _unit_rotation(q[:, adr + 3 : adr + 7])
                for i in range(3):
                    t[d + i] = mt.eye[i].expand(n, 3)
                    w[d + 3 + i] = R[..., i]
                    c[d + 3 + i] = p
            elif kind == BALL:
                anchor_w = p + R @ mt.jnt_pos[j]
                R = R @ _unit_rotation(q[:, adr : adr + 4])
                p = anchor_w - R @ mt.jnt_pos[j]
                # The axes are the child frame's, anchored at the joint.
                for i in range(3):
                    w[d + i] = R[..., i]
                    c[d + i] = anchor_w
            elif kind == SLIDE:
                axis_w = R @ mt.jnt_axis[j]
                t[d] = axis_w
                p = p + axis_w * (q[:, adr] - float(q0[adr]))[:, None]
            else:  # HINGE
                axis_w = R @ mt.jnt_axis[j]
                anchor_w = p + R @ mt.jnt_pos[j]
                w[d] = axis_w
                c[d] = anchor_w
                rot = _axis_angle(axis_w, q[:, adr] - float(q0[adr]), mt.eye)
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
    """Coordinate tangent q̇ ``[N, nq]`` of a generalized velocity: qd itself
    for hinge, slide and free translation, ``½ q ⊗ [0, ω_body]`` for each
    quaternion."""
    if model.nq == model.nv:
        return qd
    s = dof_structure(model)
    mt = model_tensors(model, q.device, q.dtype)
    qdot = q.new_zeros(q.shape)
    qdot[:, mt.nonfree_qadr] = qd[:, mt.nonfree_dadr]
    for qadr, dadr in s.free_jnts:
        qdot[:, qadr : qadr + 3] = qd[:, dadr : dadr + 3]
    for qadr, dadr in s.quat_jnts:
        omega = F.pad(qd[:, dadr : dadr + 3], (1, 0))
        qdot[:, qadr : qadr + 4] = 0.5 * _quat_mul(q[:, qadr : qadr + 4], omega)
    return qdot


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
    """qpos ← qpos ⊕ h·qd: each quaternion turns by the exponential map of
    ``h·ω`` and is renormalised."""
    if model.nq == model.nv:
        return q + h * qd
    s = dof_structure(model)
    mt = model_tensors(model, q.device, q.dtype)
    out = q.clone()
    out[:, mt.nonfree_qadr] = q[:, mt.nonfree_qadr] + h * qd[:, mt.nonfree_dadr]
    for qadr, dadr in s.free_jnts:
        out[:, qadr : qadr + 3] = q[:, qadr : qadr + 3] + h * qd[:, dadr : dadr + 3]
    for qadr, dadr in s.quat_jnts:
        omega = qd[:, dadr : dadr + 3]
        speed = torch.linalg.vector_norm(omega, dim=-1, keepdim=True)
        axis = omega / (speed + 1e-12)
        half = 0.5 * h * speed
        turn = torch.cat([torch.cos(half), torch.sin(half) * axis], -1)
        quat = _quat_mul(q[:, qadr : qadr + 4], turn)
        out[:, qadr : qadr + 4] = quat / torch.linalg.vector_norm(
            quat, dim=-1, keepdim=True
        )
    return out
