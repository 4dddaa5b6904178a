"""Pendulum, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/classic_control/pendulum.py`` (reference
``envpool/classic_control/pendulum.h:30-147``).  State is
``[N, 2] = (theta, theta_dot)``; a reset draws theta from ``U[-pi, pi)``
and theta_dot from ``U[-1, 1)``.  A step clips the torque to [-2, 2],
costs ``theta^2 + 0.1 theta_dot^2 + 0.001 u^2`` on the state before it,
integrates semi-implicit Euler with dt = 0.05 (theta advances by the
unclamped velocity, as in both reference versions) and wraps theta into
[-pi, pi).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec

_MAX_SPEED = 8.0
_MAX_TORQUE = 2.0
_DT = 0.05
_GRAVITY = 10.0


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Angles wrapped into ``[-pi, pi)`` (``jnp.mod`` semantics)."""
    return torch.remainder(theta + math.pi, 2 * math.pi) - math.pi


class PendulumEnv(TorchEnv):
    DEFAULT_CONFIG = {"version": 0}

    def state_spec(self):
        return {
            "obs": ArraySpec(
                np.float32, (3,), minimum=[-1.0, -1.0, -8.0], maximum=[1.0, 1.0, 8.0]
            ),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (1,), -2.0, 2.0)}

    def _obs(self, theta, theta_dot):
        return {
            "obs": torch.stack([torch.cos(theta), torch.sin(theta), theta_dot], 1)
        }

    def reset_draws(self, sub):
        """``theta`` ``[N]`` in ``[-pi, pi)``, ``theta_dot`` ``[N]`` in ``[-1, 1)``."""
        u = rng.uniform(sub, 0, 2)
        return {
            "theta": -math.pi + 2 * math.pi * u[:, 0],
            "theta_dot": -1.0 + 2.0 * u[:, 1],
        }

    def reset_env(self, draws):
        theta, theta_dot = draws["theta"], draws["theta_dot"]
        return torch.stack([theta, theta_dot], 1), self._obs(theta, theta_dot)

    def step_env(self, state, action, draws):
        theta, theta_dot = state.unbind(1)
        u = torch.clamp(
            action.reshape(-1).to(torch.float32), -_MAX_TORQUE, _MAX_TORQUE
        )
        cost = theta * theta + 0.1 * theta_dot * theta_dot + 0.001 * u * u
        new_theta_dot = (
            theta_dot + 3 * (_GRAVITY / 2 * torch.sin(theta) + u) * _DT
        )
        theta = wrap_angle(theta + new_theta_dot * _DT)
        theta_dot = torch.clamp(new_theta_dot, -_MAX_SPEED, _MAX_SPEED)
        return EnvOut(
            state=torch.stack([theta, theta_dot], 1),
            obs=self._obs(theta, theta_dot),
            reward=-cost,
            terminated=torch.zeros_like(theta, dtype=torch.bool),
        )
