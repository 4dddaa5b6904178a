"""dm_control suite tasks with a free base, batched: humanoid and
humanoid_CMU.

Counterpart of the humanoid tasks of ``envpool_tpu/envs/mujoco_dmc/
tasks2.py``.  The episode starts from ``randomize_joints`` (the free joint
keeps ``qpos0``), as there.  Ball-in-cup, fish, lqr and finger are left
out: they need spatial tendons, affine-bias actuators, tendon
transmissions or body-body contacts, which the port's physics does not
have yet.
"""

from __future__ import annotations

import torch

from ...physics.kinematics import _mv
from . import rewards
from .base import DmcEnv
from .tasks import _quadratic_control


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
