"""FrozenLake, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/toy_text/frozen_lake.py`` (reference
``envpool/toy_text/frozen_lake.h:34-137``).  State is ``[N, 2] = (x, y)``
int32; every step the intended action slips by a uniform draw from
{-1, 0, +1} (mod 4); the 4x4 or 8x8 map is fixed; a hole (H) ends the
episode with reward 0, the goal (G) with reward 1.  The obs is the flat
cell index ``x * size + y``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec

_MAP4 = ["SFFF", "FHFH", "FFFH", "HFFG"]
_MAP8 = [
    "SFFFFFFF",
    "FFFFFFFF",
    "FFFHFFFF",
    "FFFFFHFF",
    "FFFHFFFF",
    "FHHFFFHF",
    "FHFFHFHF",
    "FFFHFFFG",
]


class FrozenLakeEnv(TorchEnv):
    DEFAULT_CONFIG = {"reward_threshold": 0.7, "size": 4}

    def __init__(self, config):
        super().__init__(config)
        grid = np.array([list(row) for row in (_MAP8 if self._size == 8 else _MAP4)])
        # Cell kinds by flat index: 0 frozen or start, 1 hole, 2 goal.
        kind = (grid == "H") + 2 * (grid == "G")
        self._kind = torch.as_tensor(kind.reshape(-1), dtype=torch.int64, device=self.device)

    @property
    def reward_threshold(self) -> float:
        return float(self.config["reward_threshold"])

    @property
    def _size(self) -> int:
        return int(self.config["size"])

    def state_spec(self):
        n = self._size * self._size
        return {"obs": ArraySpec(np.int32, (), 0, n - 1, is_discrete=True)}

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 3, is_discrete=True)}

    def step_draws(self, sub):
        """``slip`` ``[N]`` int32 uniform in {-1, 0, 1}."""
        return {"slip": rng.randint(sub, 0, 3) - 1}

    def reset_env(self, draws):
        del draws
        n = self.num_envs
        state = torch.zeros(n, 2, dtype=torch.int32, device=self.device)
        return state, {"obs": state[:, 0].clone()}

    def step_env(self, state, action, draws):
        size = self._size
        x, y = state.unbind(1)
        act = torch.remainder(action + draws["slip"] + 4, 4)
        # 0: left (y-1), 1: down (x+1), 2: right (y+1), 3: up (x-1).
        dx = (act == 1).to(torch.int32) - (act == 3).to(torch.int32)
        dy = (act == 2).to(torch.int32) - (act == 0).to(torch.int32)
        x = torch.clamp(x + dx, 0, size - 1)
        y = torch.clamp(y + dy, 0, size - 1)
        cell = x * size + y
        kind = self._kind[cell.long()]
        return EnvOut(
            state=torch.stack([x, y], 1).to(torch.int32),
            obs={"obs": cell.to(torch.int32)},
            reward=(kind == 2).to(torch.float32),
            terminated=kind > 0,
        )
