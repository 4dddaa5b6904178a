"""MountainCar, discrete and continuous, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/classic_control/mountain_car.py``
(reference ``envpool/classic_control/mountain_car.h`` and
``mountain_car_continuous.h``).  State is ``[N, 2] = (pos, vel)``; a reset
draws pos from ``U[-0.6, -0.4)`` with vel 0.  Discrete: force
``(action - 1) · 0.001``, goal at 0.5, reward -1 per step.  Continuous:
power 0.0015, goal at 0.45, reward ``-0.1 · action²`` (of the unclipped
action) plus 100 at the goal.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec

_MIN_POS = -1.2
_MAX_POS = 0.6
_MAX_SPEED = 0.07
_GRAVITY = 0.0025


class _MountainCarBase(TorchEnv):
    _GOAL_POS = 0.5
    _GOAL_VEL = 0.0

    @property
    def reward_threshold(self) -> float:
        return float(self.config["reward_threshold"])

    def state_spec(self):
        return {
            "obs": ArraySpec(
                np.float32, (2,), minimum=[-1.2, -0.07], maximum=[0.6, 0.07]
            ),
        }

    def reset_draws(self, sub):
        """``pos`` ``[N]`` uniform in ``[-0.6, -0.4)``."""
        return {"pos": rng.uniform_range(sub, -0.6, -0.4, 1)[:, 0]}

    def reset_env(self, draws):
        pos = draws["pos"]
        state = torch.stack([pos, torch.zeros_like(pos)], 1)
        return state, {"obs": state}

    def _integrate(self, state, accel):
        """The clamped Euler update shared by both variants; returns the new
        state and whether it reached the goal."""
        pos, vel = state.unbind(1)
        vel = torch.clamp(
            vel + accel - torch.cos(3 * pos) * _GRAVITY, -_MAX_SPEED, _MAX_SPEED
        )
        pos = torch.clamp(pos + vel, _MIN_POS, _MAX_POS)
        vel = torch.where((pos == _MIN_POS) & (vel < 0), 0.0, vel)
        done = (pos >= self._GOAL_POS) & (vel >= self._GOAL_VEL)
        return torch.stack([pos, vel], 1), done


class MountainCarEnv(_MountainCarBase):
    DEFAULT_CONFIG = {"reward_threshold": -110.0}
    _FORCE = 0.001

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 2, is_discrete=True)}

    def step_env(self, state, action, draws):
        accel = (action.to(torch.float32) - 1) * self._FORCE
        new_state, terminated = self._integrate(state, accel)
        return EnvOut(
            state=new_state,
            obs={"obs": new_state},
            reward=torch.full_like(accel, -1.0),
            terminated=terminated,
        )


class MountainCarContinuousEnv(_MountainCarBase):
    DEFAULT_CONFIG = {"reward_threshold": 90.0}
    _POWER = 0.0015
    _GOAL_POS = 0.45

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (1,), -1.0, 1.0)}

    def step_env(self, state, action, draws):
        act = action.reshape(-1).to(torch.float32)
        # The reward uses the unclipped action (mountain_car_continuous.h:119-125).
        reward = -0.1 * act * act
        act = torch.clamp(act, -1.0, 1.0)
        new_state, terminated = self._integrate(state, act * self._POWER)
        return EnvOut(
            state=new_state,
            obs={"obs": new_state},
            reward=torch.where(terminated, reward + 100.0, reward),
            terminated=terminated,
        )
