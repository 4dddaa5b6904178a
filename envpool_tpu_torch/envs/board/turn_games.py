"""Turn-based two-player board games: TicTacToe, Connect4, batched.

Counterpart of ``envpool_tpu/envs/board/turn_games.py``.  Each step takes
the action of the player to move (``obs:current_player``), or that
player's row of ``[N, P]`` actions under EnvPool's per-player protocol
(``max_num_players > 1``); the reward is the mover's (+1 win, -1 illegal
move, 0 otherwise), or one row per player where the other seat gets the
negated reward of a terminal step.  Cells: 0 empty, 1 player 0, 2
player 1.  State: ``board`` ``[N, H, W]`` int32, ``player`` ``[N]`` int32.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from .common import BoardEnv, mover_action, per_player_reward

__all__ = ["TicTacToeEnv", "Connect4Env"]


class _TurnGame(BoardEnv):
    H = W = 0
    N_ACTIONS = 0

    def state_spec(self):
        return {
            "obs:board": ArraySpec(np.int32, (self.H, self.W), 0, 2),
            "obs:current_player": ArraySpec(np.int32, (), 0, 1, is_discrete=True),
            "info:legal_moves": ArraySpec(np.bool_, (self.N_ACTIONS,)),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, self.N_ACTIONS - 1, is_discrete=True)}

    def _obs(self, board, player):
        return {"obs:board": board, "obs:current_player": player,
                "info:legal_moves": self._legal(board)}

    def reset_env(self, draws):
        n = draws["rows"].shape[0]
        board = torch.zeros((n, self.H, self.W), dtype=torch.int32, device=self.device)
        player = torch.zeros(n, dtype=torch.int32, device=self.device)
        return {"board": board, "player": player}, self._obs(board, player)

    def step_env(self, state, action, draws):
        board, player = state["board"], state["player"]
        a = mover_action(action, player, self.max_num_players).long()
        n = board.shape[0]
        flat = board.reshape(n, -1)
        cell, legal = self._target(board, a)
        mark = (player + 1)[:, None]
        placed = flat.scatter(1, cell.clamp(0, flat.shape[1] - 1)[:, None], mark)
        new_board = torch.where(legal[:, None], placed, flat).reshape(board.shape)
        won = self._wins(new_board == mark[:, :, None])
        draw = (new_board != 0).flatten(1).all(1) & ~won
        terminated = won | draw | ~legal
        mover_reward = torch.where(~legal, -1.0, torch.where(won, 1.0, 0.0)).to(torch.float32)
        reward = per_player_reward(mover_reward, player, terminated, self.max_num_players)
        next_player = torch.where(terminated, player, 1 - player).to(torch.int32)
        return EnvOut(state={"board": new_board, "player": next_player},
                      obs=self._obs(new_board, next_player), reward=reward,
                      terminated=terminated)


class TicTacToeEnv(_TurnGame):
    """3x3; the action is the cell ``3 * row + col``."""

    H = W = 3
    N_ACTIONS = 9

    def _legal(self, board):
        return (board == 0).reshape(board.shape[0], -1)

    def _target(self, board, a):
        legal = board.reshape(board.shape[0], -1).gather(1, a[:, None])[:, 0] == 0
        return a, legal

    @staticmethod
    def _wins(b):
        rows = b.all(2).any(1)
        cols = b.all(1).any(1)
        diag = (torch.diagonal(b, dim1=1, dim2=2).all(1)
                | torch.diagonal(b.flip(2), dim1=1, dim2=2).all(1))
        return rows | cols | diag


class Connect4Env(_TurnGame):
    """6x7 connect-four; the action is a column, and the piece falls to
    its lowest empty row."""

    H, W = 6, 7
    N_ACTIONS = 7

    def _legal(self, board):
        return board[:, 0] == 0

    def _target(self, board, a):
        col = board.gather(2, a[:, None, None].expand(-1, self.H, 1))[:, :, 0]
        legal = col[:, 0] == 0
        row = 5 - (col != 0).sum(1)
        return row * self.W + a, legal

    @staticmethod
    def _wins(b):
        h = (b[:, :, :-3] & b[:, :, 1:-2] & b[:, :, 2:-1] & b[:, :, 3:]).flatten(1).any(1)
        v = (b[:, :-3] & b[:, 1:-2] & b[:, 2:-1] & b[:, 3:]).flatten(1).any(1)
        d1 = (b[:, :-3, :-3] & b[:, 1:-2, 1:-2] & b[:, 2:-1, 2:-1]
              & b[:, 3:, 3:]).flatten(1).any(1)
        d2 = (b[:, 3:, :-3] & b[:, 2:-1, 1:-2] & b[:, 1:-2, 2:-1]
              & b[:, :-3, 3:]).flatten(1).any(1)
        return h | v | d1 | d2
