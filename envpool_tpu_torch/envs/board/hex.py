"""Hex, batched over ``[N]`` boards.

Counterpart of ``envpool_tpu/envs/board/hex.py``: an 11x11 rhombus,
player 0 joins the top and bottom rows, player 1 the left and right
columns; no draws.  JAX grows the mover's set reachable from the first
row (or column) with a ``lax.while_loop`` until it stops growing; that
set is the union of the mover's stone groups that touch the first row,
which :func:`~.common.min_labels` finds in about a log of the passes.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from .common import BoardEnv, min_labels, mover_action, per_player_reward, shift2d

__all__ = ["HexEnv"]

_N = 11
_NBRS = ((-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0))


def connected(stones: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """``[N]``: whether the stones ``[N, 11, 11]`` of each env join player
    0's rows (player 1's columns) ``0`` and ``10``."""
    links = [(dr, dc, stones & shift2d(stones, dr, dc, False)) for dr, dc in _NBRS]
    labels = min_labels(links, _N * _N)
    p0 = (player == 0)[:, None, None]
    lab = torch.where(p0, labels, labels.transpose(1, 2))
    st = torch.where(p0, stones, stones.transpose(1, 2))
    big = _N * _N
    # the groups that touch the first row: their label is a first-row
    # cell's own (a label is its group's least flat index, the transpose's
    # for player 1's columns)
    first = torch.where(st[:, 0], lab[:, 0], big)                      # [N, 11]
    last = torch.where(st[:, -1], lab[:, -1], -1)                      # [N, 11]
    return (last[:, :, None] == first[:, None, :]).flatten(1).any(1)


class HexEnv(BoardEnv):
    def state_spec(self):
        return {
            "obs:board": ArraySpec(np.int32, (_N, _N), 0, 2),
            "obs:current_player": ArraySpec(np.int32, (), 0, 1, is_discrete=True),
            "info:legal_moves": ArraySpec(np.bool_, (_N * _N,)),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, _N * _N - 1, is_discrete=True)}

    def _obs(self, board, player):
        return {"obs:board": board, "obs:current_player": player,
                "info:legal_moves": (board == 0).reshape(board.shape[0], -1)}

    def reset_env(self, draws):
        b = draws["rows"].shape[0]
        board = torch.zeros((b, _N, _N), dtype=torch.int32, device=self.device)
        player = torch.zeros(b, dtype=torch.int32, device=self.device)
        return {"board": board, "player": player}, self._obs(board, player)

    def step_env(self, state, action, draws):
        board, player = state["board"], state["player"]
        b = board.shape[0]
        a = mover_action(action, player, self.max_num_players).long()
        flat = board.reshape(b, -1)
        legal = flat.gather(1, a[:, None])[:, 0] == 0
        placed = flat.scatter(1, a[:, None], (player + 1)[:, None])
        new_board = torch.where(legal[:, None], placed, flat).reshape(board.shape)
        won = connected(new_board == (player + 1)[:, None, None], player)
        terminated = won | ~legal
        mover_reward = torch.where(~legal, -1.0, torch.where(won, 1.0, 0.0)).to(torch.float32)
        reward = per_player_reward(mover_reward, player, terminated, self.max_num_players)
        next_player = torch.where(terminated, player, 1 - player).to(torch.int32)
        return EnvOut(state={"board": new_board, "player": next_player},
                      obs=self._obs(new_board, next_player), reward=reward,
                      terminated=terminated)
