"""Humanoid and HumanoidStandup (gym v4 semantics, the v5 toggles), batched.

Counterpart of ``envpool_tpu/envs/mujoco_gym/humanoid.py`` (reference
``envpool/mujoco/gym/humanoid.h`` / ``humanoid_standup.h``).  The com-based
observation blocks (``cinert``, ``cvel``, ``cfrc_ext``) come from the
physics' own quantities, as in the JAX env: world-frame body inertia, mass
and CoM offsets about the robot's CoM, the bodies' CoM velocities, and the
penalty contacts' normal forces summed per body.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.specs import ArraySpec
from ...physics.dynamics import (
    _kin,
    _vel_from_kin,
    _world_inertia,
    body_com_positions,
)
from ...physics.kinematics import model_tensors
from .base import MujocoGymEnv
from .tasks import _ForwardRewardEnv, _never

# The six entries of a symmetric inertia tensor, in MuJoCo's cinert order
# (xx, yy, zz, xy, xz, yz).
_SYM_ROWS = [0, 1, 2, 0, 0, 1]
_SYM_COLS = [0, 1, 2, 1, 2, 2]


class _HumanoidBase(MujocoGymEnv):
    FRAME_SKIP = 5
    UNIFORM_QVEL_NOISE = True

    def _com_obs(self, qpos, qvel):
        """``(cinert [N, nb, 10], cvel [N, nb, 6], cfrc [N, nb, 6])`` in the
        world frame, from one tree pass."""
        model = self.model
        mt = model_tensors(model, qpos.device, qpos.dtype)
        k = _kin(model, qpos)
        Iw = _world_inertia(mt, k.Rs)
        mass = mt.body_mass
        robot_com = (mass @ k.x_com) / mass.sum()
        r = k.x_com - robot_com[:, None]
        n, nb = qpos.shape[0], model.nbody
        cinert = torch.cat(
            [
                Iw[:, :, _SYM_ROWS, _SYM_COLS],
                mass[:, None] * r,
                mass[:, None].expand(n, nb, 1),
            ],
            2,
        )
        v_com, omega, v_con = _vel_from_kin(mt, k, qvel)
        cvel = torch.cat([omega, v_com], 2)
        # The normal force of each contact sphere on its body (world z).
        pen = mt.con_radius - k.centers[..., 2]
        fn = torch.where(
            pen > 0, self.contact.kp * pen - self.contact.kd * v_con[..., 2], 0.0
        )
        fz = qpos.new_zeros(n, nb).index_add_(1, mt.con_body, torch.clamp_min(fn, 0.0))
        cfrc = torch.cat([qpos.new_zeros(n, nb, 5), fz[..., None]], 2)
        # Gym v4 keeps the worldbody's rows, zero here: the 376-dim obs.
        cinert[:, 0] = 0.0
        cvel[:, 0] = 0.0
        return cinert, cvel, cfrc

    def observe(self, qpos, qvel):
        cinert, cvel, cfrc = self._com_obs(qpos, qvel)
        # The qfrc_actuator slot stays zero, as in the JAX env.
        qfrc = qvel.new_zeros(qvel.shape)
        if bool(self.config["v5_obs"]):
            # Gymnasium humanoid_v5 drops the worldbody's rows and the 6
            # root dofs of qfrc_actuator: 348 dims.
            cinert, cvel, cfrc = cinert[:, 1:], cvel[:, 1:], cfrc[:, 1:]
            qfrc = qfrc[:, 6:]
        n = qpos.shape[0]
        return torch.cat(
            [
                qpos[:, 2:],
                qvel,
                cinert.reshape(n, -1),
                cvel.reshape(n, -1),
                qfrc,
                cfrc.reshape(n, -1),
            ],
            1,
        )


class HumanoidEnv(_HumanoidBase, _ForwardRewardEnv):
    XML = "humanoid.xml"
    DEFAULT_CONFIG = {
        "reward_threshold": 0.0,
        "ctrl_cost_weight": 0.1,
        "forward_reward_weight": 1.25,
        "healthy_reward": 5.0,
        "terminate_when_unhealthy": True,
        "reset_noise_scale": 1e-2,
        "substeps": 1,
        # RK4 x frame_skip 5 x nv 23 costs 4x Euler's dynamics
        # evaluations; integrator="model" runs it.
        "integrator": "euler",
        # v5 toggles (gymnasium humanoid_v5): 348-dim obs, the healthy
        # bonus only while healthy, the contact cost in the reward.
        "v5_obs": False,
        "legacy_healthy_reward": True,
        "contact_cost_weight": 0.0,  # v5: 5e-7
        "contact_cost_max": 10.0,
    }

    def _mass_center_x(self, qpos):
        """Gym's mass_center: the mass-weighted mean of the body CoMs' x."""
        mass = model_tensors(self.model, qpos.device, qpos.dtype).body_mass
        return (body_com_positions(self.model, qpos)[..., 0] @ mass) / mass.sum()

    def reward_done(self, before, after, action):
        xv = (
            self._mass_center_x(after["qpos"]) - self._mass_center_x(before["qpos"])
        ) / self.dt
        run, ctrl_cost, info = self._forward_terms(xv, action, after["qpos"][:, 0])
        z = after["qpos"][:, 2]
        bonus, terminated = self._healthy_terms((z > 1.0) & (z < 2.0))
        reward = run + bonus - ctrl_cost
        weight = float(self.config["contact_cost_weight"])
        if weight > 0.0:
            cfrc = self._com_obs(after["qpos"], after["qvel"])[2]
            reward = reward - torch.clamp_max(
                weight * torch.sum(cfrc * cfrc, (1, 2)),
                float(self.config["contact_cost_max"]),
            )
        return reward, terminated, info


class HumanoidStandupEnv(_HumanoidBase):
    XML = "humanoidstandup.xml"
    DEFAULT_CONFIG = {
        "reward_threshold": 0.0,
        "ctrl_cost_weight": 0.1,
        "reset_noise_scale": 1e-2,
        "substeps": 1,
        "integrator": "euler",
        "v5_obs": False,
    }

    def extra_info_spec(self):
        return {
            "info:reward_linup": ArraySpec(np.float32, ()),
            "info:reward_quadctrl": ArraySpec(np.float32, ()),
        }

    def reward_done(self, before, after, action):
        uph_cost = after["qpos"][:, 2] / self.model.timestep
        quad_ctrl = float(self.config["ctrl_cost_weight"]) * torch.sum(
            action * action, 1
        )
        return (
            uph_cost - quad_ctrl + 1.0,
            _never(uph_cost),
            {"reward_linup": uph_cost, "reward_quadctrl": -quad_ctrl},
        )
