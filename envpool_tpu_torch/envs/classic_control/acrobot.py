"""Acrobot, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/classic_control/acrobot.py`` (reference
``envpool/classic_control/acrobot.h:32-203``).  State is
``[N, 4] = (theta1, theta2, dtheta1, dtheta2)``, drawn from
``U[-0.1, 0.1)`` at a reset.  A step applies torque ``action - 1``,
integrates one RK4 step with dt = 0.2, wraps the angles into [-pi, pi),
clamps the velocities to 4π and 9π, and terminates when
``-cos(t1) - cos(t1 + t2) > 1`` (reward 0, else -1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec
from .pendulum import wrap_angle

_G = 9.8
_DT = 0.2
_L = 1.0
_M = 1.0
_LC = 0.5
_I = 1.0
_MAX_VEL1 = 4 * math.pi
_MAX_VEL2 = 9 * math.pi
_INIT_RANGE = 0.1


def _derivs(s, torque):
    theta1, theta2, dtheta1, dtheta2 = s.unbind(1)
    cos2 = torch.cos(theta2)
    d1 = _M * _LC * _LC + _M * (_L * _L + _LC * _LC + 2 * _L * _LC * cos2) + _I * 2
    d2 = _M * (_LC * _LC + _L * _LC * cos2) + _I
    phi2 = _M * _LC * _G * torch.cos(theta1 + theta2 - math.pi / 2)
    phi1 = (
        -(dtheta2 + 2 * dtheta1) * _M * _L * _LC * dtheta2 * torch.sin(theta2)
        + _M * (_LC + _L) * _G * torch.cos(theta1 - math.pi / 2)
        + phi2
    )
    ddtheta2 = (
        torque
        + d2 / d1 * phi1
        - _M * _L * _LC * dtheta1 * dtheta1 * torch.sin(theta2)
        - phi2
    ) / (_M * _LC * _LC + _I - d2 * d2 / d1)
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2], 1)


def _rk4(s, torque):
    k1 = _derivs(s, torque)
    k2 = _derivs(s + k1 * (_DT / 2), torque)
    k3 = _derivs(s + k2 * (_DT / 2), torque)
    k4 = _derivs(s + k3 * _DT, torque)
    return s + (k1 + 2 * k2 + 2 * k3 + k4) * (_DT / 6.0)


class AcrobotEnv(TorchEnv):
    DEFAULT_CONFIG = {"reward_threshold": -100.0}

    @property
    def reward_threshold(self) -> float:
        return float(self.config["reward_threshold"])

    def state_spec(self):
        return {
            "obs": ArraySpec(
                np.float32,
                (6,),
                minimum=[-1.0, -1.0, -1.0, -1.0, -_MAX_VEL1, -_MAX_VEL2],
                maximum=[1.0, 1.0, 1.0, 1.0, _MAX_VEL1, _MAX_VEL2],
            ),
            "info:state": ArraySpec(np.float32, (2,)),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 2, is_discrete=True)}

    def _obs(self, s):
        theta1, theta2, dtheta1, dtheta2 = s.unbind(1)
        return {
            "obs": torch.stack(
                [
                    torch.cos(theta1),
                    torch.sin(theta1),
                    torch.cos(theta2),
                    torch.sin(theta2),
                    dtheta1,
                    dtheta2,
                ],
                1,
            ),
            "info:state": s[:, :2],
        }

    def reset_draws(self, sub):
        """``state`` ``[N, 4]`` uniform in ``[-0.1, 0.1)``."""
        return {"state": rng.uniform_range(sub, -_INIT_RANGE, _INIT_RANGE, 4)}

    def reset_env(self, draws):
        s = draws["state"]
        return s, self._obs(s)

    def step_env(self, state, action, draws):
        torque = (action - 1).to(torch.float32)
        s = _rk4(state, torque)
        theta1 = wrap_angle(s[:, 0])
        theta2 = wrap_angle(s[:, 1])
        dtheta1 = torch.clamp(s[:, 2], -_MAX_VEL1, _MAX_VEL1)
        dtheta2 = torch.clamp(s[:, 3], -_MAX_VEL2, _MAX_VEL2)
        new_state = torch.stack([theta1, theta2, dtheta1, dtheta2], 1)
        terminated = -torch.cos(theta1) - torch.cos(theta1 + theta2) > 1
        return EnvOut(
            state=new_state,
            obs=self._obs(new_state),
            reward=torch.where(terminated, 0.0, -1.0),
            terminated=terminated,
        )
