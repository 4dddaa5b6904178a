"""Taxi, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/toy_text/taxi.py`` (reference
``envpool/toy_text/taxi.h:34-133``).  A 5x5 grid with the wall map
{"|:|::|","|:|::|","|::::|","||:|:|","||:|:|"} and pickup locations
R/G/Y/B at (0,0), (0,4), (4,0), (4,3).  A reset puts the taxi in a random
cell, the passenger at location s in {0..3} and the destination t in
{0..3}.  Actions: 0 south (x+1), 1 north (x-1), 2 east, 3 west (wall-gated),
4 pickup, 5 dropoff.  State is ``[N, 4] = (x, y, s, t)`` int32 (s = 4: in
the taxi); the obs encodes ``((x*5+y)*5+s)*4+t``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec

_MAP = ["|:|::|", "|:|::|", "|::::|", "||:|:|", "||:|:|"]
_LOC = np.array([[0, 0], [0, 4], [4, 0], [4, 3]], np.int32)
# Per cell (flat x * 5 + y): the pickup location it is (-1: none), and
# whether the separator east and west of it is open (':').
_LOC_MAP = -np.ones((5, 5), np.int32)
for _i, (_x, _y) in enumerate(_LOC):
    _LOC_MAP[_x, _y] = _i
_CAN_EAST = np.array([[_MAP[x][y + 1] == ":" for y in range(5)] for x in range(5)])
_CAN_WEST = np.array([[_MAP[x][y] == ":" for y in range(5)] for x in range(5)])


class TaxiEnv(TorchEnv):
    DEFAULT_CONFIG = {"reward_threshold": 8.0}

    def __init__(self, config):
        super().__init__(config)
        dev = self.device
        self._loc = torch.as_tensor(_LOC, device=dev)
        self._loc_map = torch.as_tensor(_LOC_MAP.reshape(-1), device=dev)
        self._can_east = torch.as_tensor(_CAN_EAST.reshape(-1), device=dev)
        self._can_west = torch.as_tensor(_CAN_WEST.reshape(-1), device=dev)

    @property
    def reward_threshold(self) -> float:
        return float(self.config["reward_threshold"])

    def state_spec(self):
        return {"obs": ArraySpec(np.int32, (), 0, 499, is_discrete=True)}

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 5, is_discrete=True)}

    def reset_draws(self, sub):
        """``start`` ``[N, 4]`` int32: the taxi's row and column uniform in
        ``[0, 5)``, the passenger's and the destination's locations in
        ``[0, 4)``."""
        return {"start": torch.stack(
            [rng.randint(sub, i, n) for i, n in enumerate((5, 5, 4, 4))], 1)}

    @staticmethod
    def _encode(x, y, s, t):
        return (((x * 5 + y) * 5 + s) * 4 + t).to(torch.int32)

    def reset_env(self, draws):
        state = draws["start"].to(torch.int32)
        return state, {"obs": self._encode(*state.unbind(1))}

    def step_env(self, state, action, draws):
        x, y, s, t = state.unbind(1)
        cell = (x * 5 + y).long()
        nx = torch.where(action == 0, torch.clamp_max(x + 1, 4),
                         torch.where(action == 1, torch.clamp_min(x - 1, 0), x))
        ny = torch.where((action == 2) & self._can_east[cell], y + 1,
                         torch.where((action == 3) & self._can_west[cell], y - 1, y))
        src = self._loc[torch.clamp(s, 0, 3).long()]
        dst = self._loc[t.long()]
        at_src = (s < 4) & (x == src[:, 0]) & (y == src[:, 1])
        at_dst = (s == 4) & (x == dst[:, 0]) & (y == dst[:, 1])
        loc_map = self._loc_map[cell]
        pickup_ok = (action == 4) & at_src
        dropoff_ok = (action == 5) & at_dst
        # Dropoff at another pickup location: the passenger gets out there.
        dropoff_side = (action == 5) & ~at_dst & (s == 4) & (loc_map >= 0)
        bad = ((action == 4) & ~at_src) | ((action == 5) & ~at_dst & ~dropoff_side)
        ns = torch.where(pickup_ok, 4,
                         torch.where(dropoff_ok, t, torch.where(dropoff_side, loc_map, s)))
        reward = torch.where(dropoff_ok, 20.0, torch.where(bad, -10.0, -1.0)).to(torch.float32)
        return EnvOut(
            state=torch.stack([nx, ny, ns, t], 1).to(torch.int32),
            obs={"obs": self._encode(nx, ny, ns, t)},
            reward=reward,
            terminated=dropoff_ok,
        )
