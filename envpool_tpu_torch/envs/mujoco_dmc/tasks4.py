"""dm_control suite tasks, fourth group, batched: dog.

Counterpart of ``DogEnv`` of ``envpool_tpu/envs/mujoco_dmc/tasks3.py``, on
the model dm_control's ``dog.get_model_and_assets`` builds
(``physics.model.ASSETS``: ``dmc:dog`` for stand, walk, trot and run, which
differ only in the floor's size; ``dmc:dog_fetch`` with the ball).  As
there:

* 38 actuators (30 on joints, 8 on fixed tendons) behind first-order
  activation filters (tau 0.05), integrated in closed form per control
  step (:class:`~.tasks3.FilteredEnv`);
* the feet's and hands' touch and force sensors read the penalty contacts'
  normal force summed over each foot's (or hand's) body;
* fetch's ball does not collide with the mouth: the reward keeps its
  factored form over the ball's, the mouth's and the target's distances.

The dog's joint-space inertia is conditioned worse than ``COND_FLOAT64``
(1.07e5 at ``qpos0``, fetch's 5.29e5), so its physics steps in float64
(``DmcEnv``); its state, obs and reward stay float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import rng
from ...physics.kinematics import _mv, fk
from .rewards import tolerance
from .tasks3 import FilteredEnv

_FEET = ("foot_L", "foot_R", "hand_L", "hand_R")
# dm_control's touch sensors, in the order of the obs.
_TOUCH = ("hand_L", "hand_R", "foot_L", "foot_R")


class DogEnv(FilteredEnv):
    """dog:{stand,walk,trot,run,fetch}."""

    DOMAIN = "dog"
    CONTROL_TIMESTEP = 0.015
    DEFAULT_CONFIG = dict(FilteredEnv.DEFAULT_CONFIG, substeps=2)
    _SPEEDS = {"walk": 1.0, "trot": 3.0, "run": 9.0}

    def model_name(self):
        fetch = self.config["task_name"] == "fetch"
        return f"{super().model_name()}{'_fetch' if fetch else ''}"

    def __init__(self, config):
        super().__init__(config)
        m = self.model
        self._pelvis = self.body_index("pelvis")
        self._skull = self.body_index("skull")
        # Each foot's (or hand's) body, else its sole's (palm's), else the
        # torso, as in the JAX env; its contact spheres as a [4, nc] table.
        feet = []
        for name in _FEET:
            cands = (name, name.replace("foot", "sole").replace("hand", "palm"))
            feet.append(next((self.body_index(c) for c in cands if c in m.body_names),
                             self._torso))
        self._feet_rows = self.contact_rows(feet)
        self._act_lo, self._act_hi = (
            torch.as_tensor(np.float32(m.act_ctrlrange[:, i]), device=self.device)
            for i in (0, 1))
        # Stand-height targets from the default pose, measured in float32 on
        # the CPU (as the JAX env measures them), whatever the device.
        q0 = torch.as_tensor(m.qpos0, dtype=torch.float32)[None]
        h = fk(m, q0)[1][0, [self._torso, self._pelvis], 2].numpy()
        self._stand_height = 0.9 * h
        # The weight of everything but the world and fetch's ball.
        mass = np.asarray(m.body_mass)
        robot = np.ones(len(mass), bool)
        robot[0] = False
        if "ball" in m.body_names:
            robot[self.body_index("ball")] = False
        self._body_weight = 9.81 * float(mass[robot].sum())
        self._mass = torch.as_tensor(np.float32(mass), device=self.device)
        if self.task == "fetch":
            self._ball = self.body_index("ball")
            root = self.joint_index("ball_root")
            self._ball_qadr = int(m.jnt_qposadr[root])
            self._ball_dadr = int(m.jnt_dofadr[root])
            floor, target = self.geom_index("floor"), self.geom_index("target")
            self._floor_r = float(m.geom_size[floor][0])
            self._target_r = float(m.geom_size[target][0])
            self._target_pos = torch.as_tensor(np.float32(m.geom_pos[target]), device=self.device)
            head = self.site_index("head")
            self._head_body = int(m.site_body[head])
            self._head_local = m.site_pos[head]
            self._bite_r = float(self.consts["site_size"][self.site_index("upper_bite")][0])
            self._bites = [(int(m.site_body[s]), m.site_pos[s]) for s in (
                self.site_index("upper_bite"), self.site_index("lower_bite"))]

    # -- episode start -----------------------------------------------------

    def reset_draws(self, sub):
        """``azimuth`` ``[N]`` uniform in ``[0, 2 pi)`` (the torso's yaw),
        ``v`` ``[N, 3]`` standard normal (twice it is the start's qvel 0, 1
        and 5), ``act`` ``[N, nu]`` uniform in the control range (the
        start's activations).  fetch also: the ball's ``ball_azimuth``
        ``[N]`` uniform in ``[0, 2 pi)``, its drop ``height`` in ``[0, 3)``,
        its ``speed`` in ``[0, 5)`` and ``noise`` ``[N, 2]`` standard normal
        (0.05 times it turns the ball's heading)."""
        nu = self.model.nu
        draws = {
            "azimuth": rng.uniform_range(sub, 0.0, 2 * math.pi, 1)[:, 0],
            "v": rng.normal(sub, 1, 3),
            "act": self._act_lo + (self._act_hi - self._act_lo) * rng.uniform(sub, 7, nu),
        }
        if self.task == "fetch":
            s = 7 + nu
            draws.update(
                ball_azimuth=rng.uniform_range(sub, 0.0, 2 * math.pi, 1, slot=s)[:, 0],
                height=rng.uniform_range(sub, 0.0, 3.0, 1, slot=s + 1)[:, 0],
                speed=rng.uniform_range(sub, 0.0, 5.0, 1, slot=s + 2)[:, 0],
                noise=rng.normal(sub, s + 3, 2),
            )
        return draws

    def init_state(self, draws):
        az = draws["azimuth"]
        n = az.shape[0]
        qpos = self._qpos0.expand(n, self.model.nq).clone()
        half, zero = az / 2, 0.0 * az
        qpos[:, 3:7] = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], 1)
        qvel = qpos.new_zeros(n, self.model.nv)
        v = 2.0 * draws["v"]
        qvel[:, [0, 1, 5]] = v
        if self.task == "fetch":
            baz = draws["ball_azimuth"]
            radius = 0.75 * self._floor_r
            b, bd = self._ball_qadr, self._ball_dadr
            qpos[:, b:b + 3] = torch.stack(
                [radius * torch.sin(baz), radius * torch.cos(baz), torch.full_like(baz, 0.05)], 1)
            noise = 0.05 * draws["noise"]
            heading = torch.stack([-torch.sin(baz) + noise[:, 0], -torch.cos(baz) + noise[:, 1]], 1)
            qvel[:, bd:bd + 2] = draws["speed"][:, None] * heading
            qvel[:, bd + 2] = torch.sqrt(2 * 9.81 * draws["height"])
        extras = {"act": draws["act"], "prev_v": qpos.new_zeros(n, 3)}
        return qpos, qvel, extras

    # -- observables -------------------------------------------------------

    def _com_velocity(self, qpos, qvel):
        """``[N, 3]`` world velocity of the whole model's centre of mass."""
        v_com = self.velocities(qpos, qvel)[0]
        mass = self._mass.to(qpos.dtype)
        return torch.einsum("b,nbi->ni", mass, v_com) / mass.sum()

    def _foot_forces(self, qpos):
        """``[N, 4]`` the penalty normal force on each of ``_FEET``."""
        return self.contact_normals(qpos, self._feet_rows)

    def observe_dmc(self, qpos, qvel, extras):
        Rs, ps = self._fk(qpos)
        t = self._torso
        Rt = Rs[:, t].transpose(1, 2)
        v = self._torso_vel(qpos, qvel)
        forces = self._foot_forces(qpos)
        obs = {
            "joint_angles": qpos[:, self._hinge_qadr],
            "joint_velocites": qvel[:, self._hinge_dadr],
            "torso_pelvis_height": torch.stack([ps[:, t, 2], ps[:, self._pelvis, 2]], 1),
            "z_projection": Rs[:, [self._skull, t, self._pelvis], :, 2].flatten(1),
            "torso_com_velocity": _mv(Rt, self._com_velocity(qpos, qvel)),
            "inertial_sensors": torch.cat(
                [self._accelerometer(Rt, v, extras), _mv(Rt, v), qvel[:, 3:6]], 1),
            "foot_forces": torch.nn.functional.pad(forces[..., None], (2, 0)).flatten(1),
            "touch_sensors": forces[:, [_FEET.index(f) for f in _TOUCH]],
            "actuator_state": extras["act"],
        }
        if self.task == "fetch":
            h = self._head_body
            Rht = Rs[:, h].transpose(1, 2)
            head = self._points(qpos, h, self._head_local)
            bd = self._ball_dadr
            ball_v = qvel[:, bd:bd + 3] - self._body_vel(qpos, qvel, h)
            obs["ball_state"] = torch.cat(
                [_mv(Rht, ps[:, self._ball] - head), _mv(Rht, ball_v)], 1)
            obs["target_position"] = _mv(Rht, self._target_pos.to(qpos.dtype) - head)
        return obs

    # -- rewards -----------------------------------------------------------

    def _stand_factors(self, qpos):
        """``[N, 6]``: the torso's and the pelvis's height, the skull's, the
        torso's and the pelvis's uprightness, and the feet's support."""
        Rs, ps = self._fk(qpos)
        factors = [
            tolerance(ps[:, b, 2], bounds=(float(h), float("inf")), margin=float(h))[:, None]
            for b, h in zip((self._torso, self._pelvis), self._stand_height)
        ]
        min_cos = float(np.cos(np.deg2rad(30)))
        factors.append(tolerance(
            Rs[:, [self._skull, self._torso, self._pelvis], 2, 2],
            bounds=(min_cos, float("inf")), sigmoid="linear", margin=min_cos + 1,
            value_at_margin=0.0))
        forces = self._foot_forces(qpos)
        touch = forces[:, 0] + forces[:, 1] + forces[:, 2] + forces[:, 3]
        factors.append(tolerance(
            touch, bounds=(self._body_weight, float("inf")), margin=self._body_weight,
            sigmoid="linear", value_at_margin=0.9)[:, None])
        return torch.cat(factors, 1)

    def reward_dmc(self, qpos, qvel, action, extras):
        factors = [self._stand_factors(qpos)]
        if self.task in self._SPEEDS:
            speed = self._SPEEDS[self.task]
            Rt = self.xmat(qpos)[:, self._torso].transpose(1, 2)
            forward = tolerance(
                _mv(Rt, self._com_velocity(qpos, qvel))[:, 0],
                bounds=(speed, 2 * speed), margin=max(1.0, speed), value_at_margin=0.0,
                sigmoid="linear")
            factors.append(((4 * forward + 1) / 5)[:, None])
        elif self.task == "fetch":
            ball = self.xpos(qpos)[:, self._ball]
            upper, lower = (self._points(qpos, b, local) for b, local in self._bites)
            mouth_d = 0.5 * (torch.linalg.vector_norm(ball - upper, dim=1)
                             + torch.linalg.vector_norm(ball - lower, dim=1))
            reach = tolerance(mouth_d, bounds=(0.0, self._bite_r), sigmoid="reciprocal",
                              margin=2.0)
            reach = (6 * reach + 1) / 7
            ball_target = torch.linalg.vector_norm(ball - self._target_pos.to(qpos.dtype), dim=1)
            near = tolerance(ball_target, bounds=(0.0, self._target_r), sigmoid="reciprocal",
                             margin=self._floor_r)
            reach = torch.where(ball_target < 2 * self._target_r, 1.0, reach)
            factors.append(torch.stack([reach, (near + 1) / 2], 1))
        return torch.prod(torch.cat(factors, 1), 1)
