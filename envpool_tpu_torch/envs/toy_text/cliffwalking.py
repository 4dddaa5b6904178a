"""CliffWalking, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/toy_text/cliffwalking.py`` (reference
``envpool/toy_text/cliffwalking.h:34-119``).  A 4x12 grid, start (3, 0),
goal (3, 11); stepping onto the cliff (row 3, columns 1..10) sends the
agent back to the start with reward -100; every move costs -1.  The
slippery variant moves the action by a uniform draw from {-1, 0, +1}
(mod 4) and reports ``info:prob`` 1/3 (else 1).  State is ``[N, 2] = (x,
y)`` int32.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec


class CliffWalkingEnv(TorchEnv):
    DEFAULT_CONFIG = {"is_slippery": False}

    def state_spec(self):
        return {
            "obs": ArraySpec(np.int32, (), 0, 47, is_discrete=True),
            "info:prob": ArraySpec(np.float32, ()),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 3, is_discrete=True)}

    @property
    def _slippery(self) -> bool:
        return bool(self.config["is_slippery"])

    def step_draws(self, sub):
        """``offset`` ``[N]`` int32 uniform in {-1, 0, 1} (slippery only)."""
        return {"offset": rng.randint(sub, 0, 3) - 1} if self._slippery else {}

    def _prob(self, n):
        p = 1.0 / 3.0 if self._slippery else 1.0
        return torch.full((n,), p, dtype=torch.float32, device=self.device)

    def reset_env(self, draws):
        del draws
        n = self.num_envs
        state = torch.tensor([3, 0], dtype=torch.int32, device=self.device).repeat(n, 1)
        obs = torch.full((n,), 36, dtype=torch.int32, device=self.device)  # 3 * 12 + 0
        return state, {"obs": obs, "info:prob": torch.ones(n, device=self.device)}

    def step_env(self, state, action, draws):
        x, y = state.unbind(1)
        act = torch.remainder(action + draws["offset"] + 4, 4) if self._slippery else action
        # 0: up (x-1), 1: right (y+1), 2: down (x+1), 3: left (y-1).
        dx = (act == 2).to(torch.int32) - (act == 0).to(torch.int32)
        dy = (act == 1).to(torch.int32) - (act == 3).to(torch.int32)
        x = torch.clamp(x + dx, 0, 3)
        y = torch.clamp(y + dy, 0, 11)
        on_cliff = (x == 3) & (y > 0) & (y < 11)
        reward = torch.where(on_cliff, -100.0, -1.0).to(torch.float32)
        y = torch.where(on_cliff, 0, y)
        terminated = (x == 3) & (y == 11)
        return EnvOut(
            state=torch.stack([x, y], 1).to(torch.int32),
            obs={"obs": (x * 12 + y).to(torch.int32), "info:prob": self._prob(x.shape[0])},
            reward=reward,
            terminated=terminated,
        )
