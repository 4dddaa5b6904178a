"""dm_control suite tasks, second group, batched: ball_in_cup, fish, lqr,
finger, humanoid and humanoid_CMU.

Counterpart of ``envpool_tpu/envs/mujoco_dmc/tasks2.py``.  The constants
the JAX tasks read from their ``mujoco.MjModel`` (site and geom sizes,
joint addresses by name) come from the committed model file
(``DmcEnv.consts``).  Collision-rejection loops of dm_control's
initializers are left out, as in the JAX tasks.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ...core import rng
from ...physics.dynamics import pair_forces
from ...physics.kinematics import _mv, quat2mat
from . import rewards
from .base import DmcEnv
from .tasks import _quadratic_control


class BallInCupEnv(DmcEnv):
    """ball_in_cup:catch: a sparse reward while the ball sits in the cup.

    The string is a limited spatial tendon (the physics' limit-range
    penalty); the ball starts anywhere in the draw box, as in the JAX env
    (dm_control rejects starts inside the cup)."""

    DOMAIN = "ball_in_cup"
    CONTROL_TIMESTEP = 0.02

    def __init__(self, config):
        super().__init__(config)
        sid = self.site_index("target")
        self._target_body = int(self.model.site_body[sid])
        self._target_local = self.model.site_pos[sid]
        self._ball_body = self.body_index("ball")
        ball_r = float(self.model.geom_size[self.geom_index("ball")][0])
        # float32 - float32, as the JAX env computes it
        self._bound = (torch.as_tensor(np.float32(self.consts["site_size"][sid][[0, 2]]),
                                       device=self.device) - ball_r)

    def reset_draws(self, sub):
        """``ball`` ``[N, 2]``: x uniform in ``[-0.2, 0.2)``, z in ``[0.2,
        0.5)``."""
        return {"ball": torch.cat([rng.uniform_range(sub, -0.2, 0.2, 1),
                                   rng.uniform_range(sub, 0.2, 0.5, 1, slot=1)], 1)}

    def init_state(self, draws):
        ball = draws["ball"]
        qpos = self._qpos0.expand(ball.shape[0], -1).clone()
        qpos[:, 2:4] = ball  # cup_x, cup_z, ball_x, ball_z (slide joints)
        return qpos, qpos.new_zeros(qpos.shape[0], self.model.nv), {}

    def observe_dmc(self, qpos, qvel, extras):
        return {"position": qpos, "velocity": qvel}

    def reward_dmc(self, qpos, qvel, action, extras):
        target = self._points(qpos, self._target_body, self._target_local)
        d = (target - self.xpos(qpos)[:, self._ball_body])[:, [0, 2]].abs()
        return (d < self._bound.to(qpos.dtype)).all(1).to(torch.float32)


class FishEnv(DmcEnv):
    """fish:{upright,swim}: 3D swimming in MuJoCo's inertia-box fluid model,
    five affine-bias servos, one on a tendon transmission."""

    DOMAIN = "fish"
    CONTROL_TIMESTEP = 0.04
    _JOINT_NAMES = ("tail1", "tail_twist", "tail2", "finright_roll",
                    "finright_pitch", "finleft_roll", "finleft_pitch")

    def __init__(self, config):
        super().__init__(config)
        m = self.model
        joints = [self.joint_index(n) for n in self._JOINT_NAMES]
        self._joint_qadr = torch.as_tensor(m.jnt_qposadr[joints], dtype=torch.int64,
                                           device=self.device)
        mouth, target = self.geom_index("mouth"), self.geom_index("target")
        self._mouth_body = int(m.geom_body[mouth])
        self._mouth_local = m.geom_pos[mouth]
        self._mouth_rot = torch.as_tensor(
            quat2mat(np.float32(m.geom_quat[mouth])), device=self.device)
        self._radii = float(m.geom_size[mouth][0] + m.geom_size[target][0])
        self._torso = self.body_index("torso")

    def _extras_spec(self):
        return {"target": (3,)} if self.task == "swim" else {}

    def reset_draws(self, sub):
        """``quat`` ``[N, 4]`` standard normal (the root's orientation
        before normalisation), ``joints`` ``[N, 7]`` uniform in ``[-0.2,
        0.2)``; for ``swim`` the ``target`` ``[N, 3]`` uniform in
        ``[-0.4, 0.4) x [-0.4, 0.4) x [0.1, 0.3)``."""
        draws = {"quat": rng.normal(sub, 0, 4),
                 "joints": rng.uniform_range(sub, -0.2, 0.2, 7, slot=8)}
        if self.task == "swim":
            lo = torch.tensor([-0.4, -0.4, 0.1], device=sub.device)
            draws["target"] = lo + (torch.tensor([0.4, 0.4, 0.3], device=sub.device) - lo
                                    ) * rng.uniform(sub, 15, 3)
        return draws

    def init_state(self, draws):
        quat = draws["quat"]
        qpos = self._qpos0.expand(quat.shape[0], -1).clone()
        qpos[:, 3:7] = quat / torch.linalg.vector_norm(quat, dim=1, keepdim=True)
        qpos[:, self._joint_qadr] = draws["joints"]
        extras = {"target": draws["target"]} if self.task == "swim" else {}
        return qpos, qpos.new_zeros(qpos.shape[0], self.model.nv), extras

    def _upright(self, qpos):
        return self.xmat(qpos)[:, self._torso, 2, 2]

    def _mouth_to_target(self, qpos, extras):
        Rb = self.xmat(qpos)[:, self._mouth_body]
        mouth = self._points(qpos, self._mouth_body, self._mouth_local)
        Rm = Rb @ self._mouth_rot.to(qpos.dtype)
        return _mv(Rm.transpose(1, 2), extras["target"] - mouth)

    def observe_dmc(self, qpos, qvel, extras):
        obs = {"joint_angles": qpos[:, self._joint_qadr], "upright": self._upright(qpos)}
        if self.task == "swim":
            obs["target"] = self._mouth_to_target(qpos, extras)
        obs["velocity"] = qvel
        return obs

    def reward_dmc(self, qpos, qvel, action, extras):
        if self.task == "upright":
            return rewards.tolerance(self._upright(qpos), bounds=(1.0, 1.0), margin=1.0)
        in_target = rewards.tolerance(
            torch.linalg.vector_norm(self._mouth_to_target(qpos, extras), dim=1),
            bounds=(0, self._radii), margin=2 * self._radii,
        )
        is_upright = 0.5 * (self._upright(qpos) + 1)
        return (7 * in_target + is_upright) / 8


class LqrEnv(DmcEnv):
    """lqr:{lqr_2_1,lqr_6_2}: dm_control's procedurally generated linear
    system of springs (``lqr._make_model`` with ``RandomState(gen_seed)``).

    reward = 1 − ½(|qpos|² + 0.1·|u|²); the episode ends (discount 0) when
    ‖(qpos, qvel)‖ < 1e-6.  Its spatial tendons are not limited, so they
    exert no force, as in the JAX physics."""

    DOMAIN = "lqr"
    _COST_COEF = 0.1
    GEN_SEED = 42  # the seed of the committed models
    DEFAULT_CONFIG = dict(DmcEnv.DEFAULT_CONFIG, gen_seed=GEN_SEED)

    def model_name(self):
        name = f"{super().model_name()}_{self.config['task_name'][len('lqr_'):]}"
        if int(self.config["gen_seed"]) != self.GEN_SEED:
            raise ValueError(
                f"lqr's gen_seed={self.config['gen_seed']} has no committed model: "
                f"{name} is generated with gen_seed={self.GEN_SEED} by `python -m "
                "envpool_tpu_torch.tools.export_models` (tools/"
                "export_models.LQR_SEED)"
            )
        return name

    def reset_draws(self, sub):
        """``unit`` ``[N, nq]`` standard normal (a direction)."""
        return {"unit": rng.normal(sub, 0, self.model.nq)}

    def init_state(self, draws):
        unit = draws["unit"]
        qpos = math.sqrt(2.0) * unit / torch.linalg.vector_norm(unit, dim=1, keepdim=True)
        return qpos, qpos.new_zeros(qpos.shape[0], self.model.nv), {}

    def observe_dmc(self, qpos, qvel, extras):
        return {"position": qpos, "velocity": qvel}

    def reward_dmc(self, qpos, qvel, action, extras):
        state_cost = 0.5 * (qpos * qpos).sum(1)
        ctrl_cost = 0.5 * (action * action).sum(1)
        return 1.0 - (state_cost + ctrl_cost * self._COST_COEF)

    def terminated_dmc(self, qpos, qvel, extras):
        return torch.sqrt((qpos * qpos).sum(1) + (qvel * qvel).sum(1)) < 1e-6


@functools.lru_cache(maxsize=4)
def _with_damping(model, dof: int, damping: float):
    """``model`` with one dof's damping replaced (one object per model, so
    its ``model_tensors`` are computed once)."""
    d = np.asarray(model.dof_damping).copy()
    d[dof] = damping
    return dataclasses.replace(model, dof_damping=d)


class FingerEnv(DmcEnv):
    """finger:{spin,turn_easy,turn_hard}: body-body contacts between the
    fingertip and the spinner's capsules.

    The touch obs is ``log1p`` of the penalty normal forces of the
    (fingertip, cap1) and (fingertip, cap2) pairs, as the JAX env
    approximates the touch sensors.  ``spin`` sets the hinge's damping to
    0.03 (dm_control sets it at episode start), on a model of its own."""

    DOMAIN = "finger"
    CONTROL_TIMESTEP = 0.02
    _EASY_RADIUS = 0.07
    _HARD_RADIUS = 0.03
    _SPIN_VELOCITY = 15.0
    DEFAULT_CONFIG = dict(DmcEnv.DEFAULT_CONFIG, substeps=2)

    def __init__(self, config):
        super().__init__(config)
        m = self.model
        hinge = self.joint_index("hinge")
        self._hinge_dof = int(m.jnt_dofadr[hinge])
        if self.task == "spin":
            self.model = _with_damping(m, self._hinge_dof, 0.03)
        self.contact = self.contact._replace(pairs=True)
        self._spinner = self.body_index("spinner")
        self._tip_local = m.site_pos[self.site_index("tip")]
        cap1 = m.geom_size[self.geom_index("cap1")]
        self._turn_radius = float(cap1[0] + cap1[1])
        self._hinge_anchor_local = m.jnt_pos[hinge]
        prox, dist = self.joint_index("proximal"), self.joint_index("distal")
        self._qadr = [int(m.jnt_qposadr[prox]), int(m.jnt_qposadr[dist])]
        self._dadr = [int(m.jnt_dofadr[prox]), int(m.jnt_dofadr[dist]), self._hinge_dof]
        # The (fingertip, cap1/cap2) pairs: touchtop, touchbottom.
        distal = self.body_index("distal")
        self._touch_pairs = [i for i in range(len(m.pair_body))
                             if int(m.pair_body[i][0]) == distal][:2]

    def _extras_spec(self):
        return {} if self.task == "spin" else {"target": (2,)}  # (x, z) from the hinge

    def reset_draws(self, sub):
        """``joints`` of :meth:`randomize_joints` and the target's ``angle``
        uniform in ``[-pi, pi)``."""
        nj = len(self._rand_joints)
        return {"joints": self.randomize_joints(sub),
                "angle": rng.uniform_range(sub, -math.pi, math.pi, 1, slot=nj)[:, 0]}

    def init_state(self, draws):
        qpos, qvel, _ = super().init_state(draws)
        extras = {}
        if self.task != "spin":
            angle = draws["angle"]
            extras["target"] = self._turn_radius * torch.stack(
                [torch.sin(angle), torch.cos(angle)], 1)
        return qpos, qvel, extras

    def _tip_rel(self, qpos):
        """``[N, 2]``: (x, z) of the tip site from the hinge's anchor."""
        anchor = self._points(qpos, self._spinner, self._hinge_anchor_local)
        tip = self._points(qpos, self._spinner, self._tip_local)
        return (tip - anchor)[:, [0, 2]]

    def _dist_to_target(self, qpos, extras):
        radius = self._EASY_RADIUS if self.task == "turn_easy" else self._HARD_RADIUS
        return torch.linalg.vector_norm(extras["target"] - self._tip_rel(qpos), dim=1) - radius

    def observe_dmc(self, qpos, qvel, extras):
        forces = pair_forces(self.model, qpos, qvel, self.contact)
        obs = {
            "position": torch.cat([qpos[:, self._qadr], self._tip_rel(qpos)], 1),
            "velocity": qvel[:, self._dadr],
            "touch": torch.log1p(forces[:, self._touch_pairs]),
        }
        if self.task != "spin":
            obs["target_position"] = extras["target"]
            obs["dist_to_target"] = self._dist_to_target(qpos, extras)
        return obs

    def reward_dmc(self, qpos, qvel, action, extras):
        if self.task == "spin":
            return (qvel[:, self._hinge_dof] <= -self._SPIN_VELOCITY).to(torch.float32)
        return (self._dist_to_target(qpos, extras) <= 0).to(torch.float32)


class DmcHumanoidEnv(DmcEnv):
    """humanoid:{stand,walk,run,run_pure_state}."""

    DOMAIN = "humanoid"
    CONTROL_TIMESTEP = 0.025
    _STAND_HEIGHT = 1.4
    _SPEEDS = {"stand": 0.0, "walk": 1.0, "run": 10.0, "run_pure_state": 10.0}
    DEFAULT_CONFIG = dict(DmcEnv.DEFAULT_CONFIG, substeps=2)

    _TORSO = "torso"
    _HEAD = "head"
    _LIMBS = ("left_hand", "left_foot", "right_hand", "right_foot")
    _UPRIGHT_INDEX = (2, 2)  # xmat zz

    def __init__(self, config):
        super().__init__(config)
        self._torso = self.body_index(self._TORSO)
        self._head = self.body_index(self._HEAD)
        self._limbs = [self.body_index(n) for n in self._LIMBS]

    def _com_velocity(self, qpos, qvel):
        """``[N, 3]``: the velocity of the whole body's centre of mass."""
        v_com = self.velocities(qpos, qvel)[0]
        m = torch.as_tensor(self.model.body_mass, dtype=qpos.dtype, device=qpos.device)
        return torch.einsum("b,nbk->nk", m, v_com) / m.sum()

    def observe_dmc(self, qpos, qvel, extras):
        if self.task == "run_pure_state":
            return {"position": qpos, "velocity": qvel}
        Rs, ps = self._fk(qpos)
        torso_R, torso_p = Rs[:, self._torso], ps[:, self._torso]
        rel = ps[:, self._limbs] - torso_p[:, None]
        ext = _mv(torso_R.transpose(1, 2)[:, None], rel).flatten(1)
        return {
            "joint_angles": qpos[:, 7:],
            "head_height": ps[:, self._head, 2],
            "extremities": ext,
            "torso_vertical": torso_R[:, 2, :],
            "com_velocity": self._com_velocity(qpos, qvel),
            "velocity": qvel,
        }

    def reward_dmc(self, qpos, qvel, action, extras):
        Rs, ps = self._fk(qpos)
        standing = rewards.tolerance(
            ps[:, self._head, 2],
            bounds=(self._STAND_HEIGHT, float("inf")),
            margin=self._STAND_HEIGHT / 4,
        )
        i, j = self._UPRIGHT_INDEX
        upright = rewards.tolerance(
            Rs[:, self._torso, i, j],
            bounds=(0.9, float("inf")),
            sigmoid="linear",
            margin=1.9,
            value_at_margin=0,
        )
        stand_reward = standing * upright
        small_control = (4 + torch.mean(_quadratic_control(action), 1)) / 5
        com_v = self._com_velocity(qpos, qvel)[:, :2]
        speed = self._SPEEDS[self.task]
        if speed == 0.0:
            dont_move = torch.mean(rewards.tolerance(com_v, margin=2), 1)
            return small_control * stand_reward * dont_move
        move = rewards.tolerance(
            torch.linalg.vector_norm(com_v, dim=1),
            bounds=(speed, float("inf")),
            margin=speed,
            value_at_margin=0,
            sigmoid="linear",
        )
        return small_control * stand_reward * (5 * move + 1) / 6


class HumanoidCMUEnv(DmcHumanoidEnv):
    """humanoid_CMU:{stand,walk,run}: the 56-actuator CMU skeleton, with
    humanoid's rewards and its upright read from the thorax's ``zy``."""

    DOMAIN = "humanoid_CMU"
    CONTROL_TIMESTEP = 0.02
    _SPEEDS = {"stand": 0.0, "walk": 1.0, "run": 10.0}

    _TORSO = "thorax"
    _HEAD = "head"
    _LIMBS = ("lhand", "lfoot", "rhand", "rfoot")
    _UPRIGHT_INDEX = (2, 1)  # xmat zy
