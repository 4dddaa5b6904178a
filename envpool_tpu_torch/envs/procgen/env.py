"""Procgen env, batched over ``[N]`` envs: game cores → the reference env
surface.

Counterpart of ``envpool_tpu/envs/procgen/env.py``.  Obs ``(64, 64, 3)``
uint8 RGB, 15 discrete actions, ``info:level_seed`` and
``info:prev_level_complete``.  A reset draws the level seed ``lvl`` in the
``[start_level, start_level + num_levels)`` window (``[0, 2**31 - 1)`` when
``num_levels`` is 0) and builds the level from ``lvl`` alone: a stream of
``core/rng.py`` seeded with ``lvl`` makes the game's level draws
(:meth:`ProcgenEnv.level_draws`), so two envs with the same level seed get
the same start.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ...core.env import INT32_MAX, EnvOut, TorchEnv
from ...core.specs import ArraySpec
from . import grid_games, platform_games, scroll_games
from .core import N_ACTIONS, RES

GAMES = {
    "maze": (grid_games.MazeGame, 15),
    "heist": (grid_games.HeistGame, 15),
    "chaser": (grid_games.ChaserGame, 15),
    "miner": (grid_games.MinerGame, 15),
    "bigfish": (scroll_games.BigfishGame, 0),
    "starpilot": (scroll_games.StarpilotGame, 0),
    "fruitbot": (scroll_games.FruitbotGame, 0),
    "dodgeball": (scroll_games.DodgeballGame, 0),
    "bossfight": (scroll_games.BossfightGame, 0),
    "caveflyer": (scroll_games.CaveflyerGame, 0),
    "plunder": (scroll_games.PlunderGame, 0),
    "coinrun": (platform_games.CoinrunGame, 0),
    "ninja": (platform_games.NinjaGame, 0),
    "jumper": (platform_games.JumperGame, 0),
    "climber": (platform_games.ClimberGame, 0),
    "leaper": (platform_games.LeaperGame, 0),
}

# World size of the grid games by distribution mode.
_GRID_SIZE = {"easy": 11, "hard": 15, "extreme": 19, "exploration": 19, "memory": 23}


class ProcgenEnv(TorchEnv):
    DEFAULT_CONFIG = {
        "env_name": "coinrun",
        "distribution_mode": "easy",
        "num_levels": 0,
        "start_level": 0,
    }

    def __init__(self, config):
        super().__init__(config)
        name = str(config["env_name"])
        mode = str(config["distribution_mode"])
        cls, size = GAMES[name]
        if size:
            size = _GRID_SIZE.get(mode, 15) | 1  # odd for the maze generator
        self.game = cls(size, mode, self.device)
        self.num_levels = int(config["num_levels"])
        self.start_level = int(config["start_level"])

    def state_spec(self):
        return {
            "obs": ArraySpec(np.uint8, (RES, RES, 3), 0, 255),
            "info:level_seed": ArraySpec(np.int32, ()),
            "info:prev_level_complete": ArraySpec(np.int32, (), 0, 1),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, N_ACTIONS - 1, is_discrete=True)}

    def reset_draws(self, sub):
        """``lvl`` ``[N]`` int32: the level seed in the configured window."""
        if self.num_levels > 0:
            lvl = self.start_level + rng.randint(sub, 0, self.num_levels)
        else:
            lvl = rng.randint(sub, 0, INT32_MAX)
        return {"lvl": lvl.to(torch.int32)}

    def level_draws(self, lvl: torch.Tensor) -> dict:
        """The game's level draws from the stream seeded with ``lvl``."""
        stream = lvl.to(torch.int64) & 0xFFFFFFFF
        _, sub = rng.split(torch.stack([stream, torch.zeros_like(stream)], 1))
        return self.game.init_draws(sub)

    def step_draws(self, sub):
        return self.game.tick_draws(sub)

    def _obs(self, g, lvl, complete):
        return {
            "obs": self.game.render(g),
            "info:level_seed": lvl,
            "info:prev_level_complete": complete,
        }

    def frame_float(self, state):
        """The frame of env state ``state`` as floats (for the frame rule
        of ``ops/thresholds.py``; the games render whole colours)."""
        return self.game.render(state["g"]).to(torch.float64)

    def frame_mask(self, mask, filled):
        """The obs is the frame."""
        del filled
        return mask

    def reset_env(self, draws):
        lvl = draws["lvl"]
        g = self.game.init(self.level_draws(lvl), lvl.shape[0])
        complete = torch.zeros_like(lvl)
        return {"g": g, "lvl": lvl, "complete": complete}, self._obs(g, lvl, complete)

    def step_env(self, state, action, draws):
        a = torch.clamp(action.reshape(-1).to(torch.int32), 0, N_ACTIONS - 1)
        g, reward, done = self.game.tick(state["g"], a, draws)
        complete = torch.where(done & (reward > 0), 1, state["complete"]).to(torch.int32)
        st = {"g": g, "lvl": state["lvl"], "complete": complete}
        return EnvOut(
            state=st,
            obs=self._obs(g, state["lvl"], complete),
            reward=reward.to(torch.float32),
            terminated=done,
        )
