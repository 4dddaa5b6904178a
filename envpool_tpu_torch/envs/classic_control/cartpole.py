"""CartPole, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/classic_control/cartpole.py`` (reference
``envpool/classic_control/cartpole.h:32-133``).  State is
``[N, 4] = (x, x_dot, theta, theta_dot)``; a reset draws all four from
``U[-0.05, 0.05)``; Euler with tau = 0.02; termination at ``|x| > 2.4`` or
``|theta| > 12°``; reward 1 per step.  The float32 arithmetic follows the
JAX env operation by operation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec

_GRAVITY = 9.8
_MASS_CART = 1.0
_MASS_POLE = 0.1
_MASS_TOTAL = _MASS_CART + _MASS_POLE
_LENGTH = 0.5
_MASS_POLE_LENGTH = _MASS_POLE * _LENGTH
_FORCE_MAG = 10.0
_TAU = 0.02
_THETA_THRESHOLD = 12 * 2 * math.pi / 360
_X_THRESHOLD = 2.4
_INIT_RANGE = 0.05


class CartPoleEnv(TorchEnv):
    DEFAULT_CONFIG = {"reward_threshold": 195.0}

    @property
    def reward_threshold(self) -> float:
        return float(self.config["reward_threshold"])

    def state_spec(self):
        inf = float("inf")
        return {
            "obs": ArraySpec(
                np.float32,
                (4,),
                minimum=[-4.8, -inf, -math.pi / 7.5, -inf],
                maximum=[4.8, inf, math.pi / 7.5, inf],
            ),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 1, is_discrete=True)}

    def reset_draws(self, sub):
        """``state`` ``[N, 4]`` uniform in ``[-0.05, 0.05)``."""
        return {"state": rng.uniform_range(sub, -_INIT_RANGE, _INIT_RANGE, 4)}

    def reset_env(self, draws):
        state = draws["state"]
        return state, {"obs": state}

    def step_env(self, state, action, draws):
        x, x_dot, theta, theta_dot = state.unbind(1)
        force = torch.where(action == 1, _FORCE_MAG, -_FORCE_MAG)
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (
            force + _MASS_POLE_LENGTH * theta_dot * theta_dot * sintheta
        ) / _MASS_TOTAL
        theta_acc = (_GRAVITY * sintheta - costheta * temp) / (
            _LENGTH
            * (4.0 / 3.0 - _MASS_POLE * costheta * costheta / _MASS_TOTAL)
        )
        x_acc = temp - _MASS_POLE_LENGTH * theta_acc * costheta / _MASS_TOTAL
        x = x + _TAU * x_dot
        x_dot = x_dot + _TAU * x_acc
        theta = theta + _TAU * theta_dot
        theta_dot = theta_dot + _TAU * theta_acc
        new_state = torch.stack([x, x_dot, theta, theta_dot], 1)
        terminated = (
            (x < -_X_THRESHOLD)
            | (x > _X_THRESHOLD)
            | (theta < -_THETA_THRESHOLD)
            | (theta > _THETA_THRESHOLD)
        )
        return EnvOut(
            state=new_state,
            obs={"obs": new_state},
            reward=torch.ones_like(x),
            terminated=terminated,
        )

    # -- rendering (reference: render_utils RenderCartPole, 600x400) -------

    render_size = (400, 600)

    def render_state(self, state):
        """``[N, 400, 600, 3]`` uint8: the track, the cart and the pole,
        pixel tests as in the JAX env's ``render_state``."""
        h, w = self.render_size
        x, theta = state[:, 0, None, None], state[:, 2, None, None]
        scale = w / (2 * 2.4 * 2)
        cart_x = w / 2 + x * scale
        cart_y = h * 0.75
        rows = torch.arange(h, dtype=torch.float32, device=state.device)[:, None]
        cols = torch.arange(w, dtype=torch.float32, device=state.device)[None, :]
        track = (rows >= cart_y + 14) & (rows <= cart_y + 16)
        cart = ((cols - cart_x).abs() <= 25) & (rows >= cart_y - 15) & (rows <= cart_y + 15)
        # Pole: the pixels in the pole's frame (length 100, width 10).
        dx = cols - cart_x
        dy = cart_y - 15 - rows  # up is positive
        ct, st = torch.cos(theta), torch.sin(theta)
        along = dx * st + dy * ct
        across = dx * ct - dy * st
        pole = (along >= 0) & (along <= 100) & (across.abs() <= 5)

        def rgb(*c):
            return torch.tensor(c, dtype=torch.uint8, device=state.device)

        frame = torch.full((x.shape[0], h, w, 3), 255, dtype=torch.uint8, device=state.device)
        frame = torch.where(pole[..., None], rgb(202, 152, 101), frame)
        return torch.where((cart | track)[..., None], rgb(0, 0, 0), frame)
