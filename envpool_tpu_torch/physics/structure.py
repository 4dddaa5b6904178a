"""Static dof-level structure derived from a PhysModel (numpy, cached).

A copy of ``envpool_tpu/physics/structure.py``.  This module precomputes
the *structure* (which dof moves which body, and which dofs precede which) so
that Jacobians and all velocity-product (bias) terms become closed-form
masked einsums off a **single** FK pass:

  * every dof k is a screw: linear direction ``t_k``, rotation axis ``w_k``
    anchored at ``c_k`` (all world-frame, emitted by ``kinematics.fk_dof``);
  * body mask ``M[k, b]`` — dof k moves body b (ancestor-or-self, with the
    chain cut at free joints, matching ``fk``'s absolute free-joint frames);
  * precedence mask ``P[k2, k]`` — dof k2 moves the frame carrying dof k's
    axis/anchor, which yields exact time-derivatives of the Jacobian
    columns (the Coriolis/centrifugal terms) by the product rule.

Behavioral reference: this replaces what MuJoCo computes in
``mj_comPos``/``mj_comVel``/``mj_rne`` (reference steps real MuJoCo on CPU
threads, ``envpool/mujoco/gym/mujoco_env.h:45-267``); correctness is pinned
by the oracle tests in ``tests/test_physics.py``.
"""

from __future__ import annotations

import functools

import numpy as np

from .model import BALL, FREE, HINGE, SLIDE, PhysModel

__all__ = ["DofStructure", "dof_structure"]

# Per-dof kinds.
D_SLIDE, D_HINGE, D_FREET, D_FREER, D_BALL = 0, 1, 2, 3, 4


class DofStructure:
    """Numpy structure tables; one instance per PhysModel (cached)."""

    def __init__(self, model: PhysModel):
        nv, nb = model.nv, model.nbody
        nj = len(model.jnt_type)

        dof_jnt = np.zeros(nv, np.int32)
        dof_body = np.zeros(nv, np.int32)
        dof_kind = np.zeros(nv, np.int32)
        for j in range(nj):
            jt = int(model.jnt_type[j])
            d = int(model.jnt_dofadr[j])
            b = int(model.jnt_body[j])
            if jt == FREE:
                for i in range(3):
                    dof_jnt[d + i], dof_body[d + i] = j, b
                    dof_kind[d + i] = D_FREET
                    dof_jnt[d + 3 + i], dof_body[d + 3 + i] = j, b
                    dof_kind[d + 3 + i] = D_FREER
            elif jt == BALL:
                for i in range(3):
                    dof_jnt[d + i], dof_body[d + i] = j, b
                    dof_kind[d + i] = D_BALL
            elif jt in (SLIDE, HINGE):
                dof_jnt[d], dof_body[d] = j, b
                dof_kind[d] = D_SLIDE if jt == SLIDE else D_HINGE
            else:  # pragma: no cover - guarded at model load
                raise NotImplementedError(f"joint type {jt}")

        # Does body b carry a free joint (its fk frame is absolute)?
        has_free = np.zeros(nb, bool)
        for j in range(nj):
            if int(model.jnt_type[j]) == FREE:
                has_free[int(model.jnt_body[j])] = True

        # anc[a, b]: motion of body a's frame moves body b (a ancestor-or-
        # self of b, chain cut *above* free-jointed bodies).
        anc = np.zeros((nb, nb), bool)
        for b in range(nb):
            x = b
            while x != 0:
                anc[x, b] = True
                if has_free[x]:
                    break
                x = int(model.body_parent[x])

        # M[k, b]: dof k moves body b.
        body_mask = anc[dof_body]  # [nv, nb]

        # P[k2, k]: dof k2 moves the frame in which dof k's screw lives.
        prec = np.zeros((nv, nv), bool)
        for k in range(nv):
            if dof_kind[k] == D_FREET:
                continue  # world-fixed translation axes
            if dof_kind[k] == D_FREER:
                # Axis = body rotation columns, anchor = body origin: both
                # driven only by the same free joint's 6 dofs (self-pairs
                # contribute w x w = 0 / c - c = 0 — harmless, exact).
                prec[:, k] = dof_jnt == dof_jnt[k]
                continue
            b, j = int(dof_body[k]), int(dof_jnt[k])
            for k2 in range(nv):
                b2, j2 = int(dof_body[k2]), int(dof_jnt[k2])
                if b2 == b:
                    # Ball axes (child-frame columns) are rotated by the
                    # ball's OWN dofs too (self-pairs give w x w = 0,
                    # harmless); hinge/slide axes only by earlier joints.
                    prec[k2, k] = (
                        j2 <= j if dof_kind[k] == D_BALL else j2 < j
                    )
                else:
                    prec[k2, k] = anc[b2, b]

        self.dof_jnt = dof_jnt
        self.dof_body = dof_body
        self.dof_kind = dof_kind
        self.body_mask = body_mask.astype(np.float32)
        self.prec = prec.astype(np.float32)
        # Contact mask [nv, ncon]: dof k moves contact sphere c.
        if len(model.con_body):
            self.con_mask = body_mask[:, np.asarray(model.con_body)].astype(
                np.float32
            )
        else:
            self.con_mask = np.zeros((nv, 0), np.float32)

        # Hinge/slide joint tables for vectorized passive/limit forces.
        hs = [j for j in range(nj) if int(model.jnt_type[j]) in (SLIDE, HINGE)]
        self.hs_jnt = np.asarray(hs, np.int32)  # joint id per hs row
        self.hs_qadr = np.asarray(
            [int(model.jnt_qposadr[j]) for j in hs], np.int32
        )
        self.hs_dadr = np.asarray(
            [int(model.jnt_dofadr[j]) for j in hs], np.int32
        )
        self.hs_stiffness = np.asarray(
            [float(model.jnt_stiffness[j]) for j in hs], np.float32
        )
        self.hs_springref = np.asarray(
            [float(model.qpos_spring[int(model.jnt_qposadr[j])]) for j in hs],
            np.float32,
        )
        self.hs_limited = np.asarray(
            [bool(model.jnt_limited[j]) for j in hs], bool
        )
        self.hs_lo = np.asarray(
            [
                float(model.jnt_range[j][0]) if model.jnt_limited[j] else -np.inf
                for j in hs
            ],
            np.float32,
        )
        self.hs_hi = np.asarray(
            [
                float(model.jnt_range[j][1]) if model.jnt_limited[j] else np.inf
                for j in hs
            ],
            np.float32,
        )

        # Actuator moment rows: per actuator, ((dof, coef), ...) where
        # τ[dof] += coef · clip(ctrl).  Joint transmission → one entry with
        # coef = gear·gain; fixed-tendon transmission (mjTRN_TENDON) →
        # the tendon's joint coefs scaled by gear·gain.
        nu = model.nu
        gains = (
            model.act_gain
            if model.act_gain is not None
            else np.ones(nu)
        )
        trntype = (
            model.act_trntype
            if model.act_trntype is not None
            else np.zeros(nu, np.int32)
        )
        biastype = (
            model.act_biastype
            if model.act_biastype is not None
            else np.zeros(nu, np.int32)
        )
        biasprm = (
            model.act_biasprm
            if model.act_biasprm is not None
            else np.zeros((nu, 3))
        )
        moments = []
        affine = []  # biastype-1 servos: (gain, b1, b2, ((qadr,dadr,coef),…))
        for a in range(nu):
            gear = float(model.act_gear[a])
            gg = gear * float(gains[a])
            if int(trntype[a]) == 3:  # tendon
                ten = model.ten_fixed[int(model.act_trnid[a])]
                rows = tuple(
                    (qadr, dadr, coef * gear) for qadr, dadr, coef in ten
                )
            else:  # joint
                j = int(model.act_trnid[a])
                rows = (
                    (int(model.jnt_qposadr[j]), int(model.jnt_dofadr[j]), gear),
                )
            if int(biastype[a]) == 1:
                # Affine servo: force = gain·ctrl + b1·len + b2·vel with
                # len/vel through the gear-scaled transmission rows; skip
                # the legacy constant-gain path for this actuator.
                moments.append(())
                affine.append(
                    (
                        a,
                        float(gains[a]),
                        float(biasprm[a][1]),
                        float(biasprm[a][2]),
                        rows,
                    )
                )
            else:
                moments.append(
                    tuple((dadr, coef * float(gains[a])) for _, dadr, coef in rows)
                )
        self.act_moments = tuple(moments)
        self.act_affine = tuple(affine)
        # Legacy single-dof view (used by the einsum path's scatter-add);
        # affine actuators have empty moment rows — fall back to dof 0
        # (their force flows through act_affine instead).
        self.act_dadr = np.asarray(
            [mo[0][0] if mo else 0 for mo in moments], np.int32
        ) if nu else np.zeros(0, np.int32)
        self.act_gear = np.asarray(
            [float(model.act_gear[a]) for a in range(nu)], np.float32
        )
        self.act_lo = np.asarray(
            [
                float(model.act_ctrlrange[a][0])
                if model.act_ctrllimited[a]
                else -np.inf
                for a in range(nu)
            ],
            np.float32,
        )
        self.act_hi = np.asarray(
            [
                float(model.act_ctrlrange[a][1])
                if model.act_ctrllimited[a]
                else np.inf
                for a in range(nu)
            ],
            np.float32,
        )

        # Free joints (for tangent / qpos integration).
        self.free_jnts = [
            (int(model.jnt_qposadr[j]), int(model.jnt_dofadr[j]))
            for j in range(nj)
            if int(model.jnt_type[j]) == FREE
        ]
        # Quaternion blocks (qadr, dadr): free-joint rotations + balls —
        # both use body-frame angular velocity with q-dot = 0.5 q (x)
        # [0, w] and exp-map integration.
        self.quat_jnts = [
            (qadr + 3, dadr + 3) for qadr, dadr in self.free_jnts
        ] + [
            (int(model.jnt_qposadr[j]), int(model.jnt_dofadr[j]))
            for j in range(nj)
            if int(model.jnt_type[j]) == BALL
        ]
        # Non-free qpos<->dof index maps (scatter/gather in one op).
        nf_q, nf_d = [], []
        for j in range(nj):
            if int(model.jnt_type[j]) in (SLIDE, HINGE):
                nf_q.append(int(model.jnt_qposadr[j]))
                nf_d.append(int(model.jnt_dofadr[j]))
        self.nonfree_qadr = np.asarray(nf_q, np.int32)
        self.nonfree_dadr = np.asarray(nf_d, np.int32)


@functools.lru_cache(maxsize=64)
def dof_structure(model: PhysModel) -> DofStructure:
    return DofStructure(model)
