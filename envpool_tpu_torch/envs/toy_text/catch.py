"""Catch (bsuite), batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/toy_text/catch.py`` (reference
``envpool/toy_text/catch.h:29-96``).  A ball falls from row 0 in a random
column; the paddle moves on the bottom row; when the ball reaches row
``height - 1`` the episode ends with reward +1 if the paddle is under it,
else -1.  State is ``[N, 3] = (ball row, ball column, paddle)`` int32; the
obs is the ``(height, width)`` board with the ball's and the paddle's
cells set to 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec


class CatchEnv(TorchEnv):
    DEFAULT_CONFIG = {"height": 10, "width": 5}

    @property
    def _height(self) -> int:
        return int(self.config["height"])

    @property
    def _width(self) -> int:
        return int(self.config["width"])

    def state_spec(self):
        return {"obs": ArraySpec(np.float32, (self._height, self._width), 0.0, 1.0)}

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 2, is_discrete=True)}

    def reset_draws(self, sub):
        """``column`` ``[N]`` int32 uniform in ``[0, width)``: the ball's."""
        return {"column": rng.randint(sub, 0, self._width)}

    def _obs(self, state):
        n = state.shape[0]
        rows = torch.arange(n, device=state.device)
        board = torch.zeros(n, self._height, self._width, dtype=torch.float32,
                            device=state.device)
        x, y, paddle = state.long().unbind(1)
        # A ball past the board (the step branch of a row that resets) is
        # dropped, as JAX drops an out-of-bounds scatter.
        board[rows, x.clamp(max=self._height - 1), y] = (x < self._height).to(torch.float32)
        board[rows, self._height - 1, paddle] = 1.0
        return {"obs": board}

    def reset_env(self, draws):
        y = draws["column"].to(torch.int32)
        x = torch.zeros_like(y)
        paddle = torch.full_like(y, self._width // 2)
        state = torch.stack([x, y, paddle], 1)
        return state, self._obs(state)

    def step_env(self, state, action, draws):
        x, y, paddle = state.unbind(1)
        paddle = torch.clamp(paddle + action - 1, 0, self._width - 1)
        x = x + 1
        terminated = x == self._height - 1
        caught = torch.where(y == paddle, 1.0, -1.0)
        reward = torch.where(terminated, caught, 0.0).to(torch.float32)
        new_state = torch.stack([x, y, paddle], 1).to(torch.int32)
        return EnvOut(
            state=new_state,
            obs=self._obs(new_state),
            reward=reward,
            terminated=terminated,
        )
