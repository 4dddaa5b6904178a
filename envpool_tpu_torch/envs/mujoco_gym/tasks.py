"""Gym-MuJoCo locomotion tasks (v4 semantics), batched.

Counterpart of ``envpool_tpu/envs/mujoco_gym/tasks.py`` (reference
``envpool/mujoco/gym/half_cheetah.h:136-155``).  HalfCheetah is ported.
"""

from __future__ import annotations

import torch

from .base import MujocoGymEnv


class HalfCheetahEnv(MujocoGymEnv):
    XML = "half_cheetah.xml"
    FRAME_SKIP = 5
    DEFAULT_CONFIG = {
        "reward_threshold": 4800.0,
        "ctrl_cost_weight": 0.1,
        "forward_reward_weight": 1.0,
        "reset_noise_scale": 0.1,
    }

    def observe(self, qpos, qvel):
        if self.config["exclude_current_positions_from_observation"]:
            qpos = qpos[:, 1:]
        return torch.cat([qpos, qvel], 1)

    def reward_done(self, before, after, action):
        xv = (after["qpos"][:, 0] - before["qpos"][:, 0]) / self.dt
        ctrl_cost = float(self.config["ctrl_cost_weight"]) * torch.sum(
            action * action, 1
        )
        run = float(self.config["forward_reward_weight"]) * xv
        return (
            run - ctrl_cost,
            torch.zeros_like(xv, dtype=torch.bool),
            {
                "reward_run": run,
                "reward_ctrl": -ctrl_cost,
                "x_position": after["qpos"][:, 0],
                "x_velocity": xv,
            },
        )
