"""Othello (Reversi), batched over ``[N]`` boards.

Counterpart of ``envpool_tpu/envs/board/othello.py``: 8x8, a move must
flip at least one line of opponent discs in one of 8 directions, a player
without a legal move passes automatically, the game ends when neither
side can move, and the final reward is +-1 by disc count (0 on a tie).
JAX's ``vmap`` of one move's walk over the 64 actions (``_legal_mask``)
is one ``[N, 64]`` pass here: per direction, the length of the run of
opponent discs that one of the mover's closes.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from .common import BoardEnv, mover_action, per_player_reward, rows

__all__ = ["OthelloEnv"]

_N = 8
_DIRS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def _closed_runs(board: torch.Tensor, cells: torch.Tensor, me: torch.Tensor) -> torch.Tensor:
    """``[N, M, 8]`` int: per move ``cells`` ``[N, M]`` (flat squares) and
    direction, the length of the run of opponent discs closed by one of
    ``me`` (0 where none is closed: the walk meets an empty cell, the
    border, or the mover's disc at once)."""
    b = board.shape[0]
    flat = board.reshape(b, -1)
    r, c = cells // _N, cells % _N
    opp = (3 - me)[:, None]
    me = me[:, None]
    out = []
    for dr, dc in _DIRS:
        still = torch.ones_like(cells, dtype=torch.bool)
        run = torch.zeros_like(cells)
        for k in range(1, _N):
            rr, cc = r + dr * k, c + dc * k
            inside = (rr >= 0) & (rr < _N) & (cc >= 0) & (cc < _N)
            cell = flat.gather(1, (rr.clamp(0, _N - 1) * _N + cc.clamp(0, _N - 1)))
            run = torch.where(still & inside & (cell == me), k - 1, run)
            still = still & inside & (cell == opp)
        out.append(run)
    return torch.stack(out, -1)


def legal_mask(board: torch.Tensor, player: torch.Tensor) -> torch.Tensor:
    """``[N, 64]``: the legal moves of ``player`` (``othello.py::_legal_mask``)."""
    b = board.shape[0]
    cells = torch.arange(_N * _N, device=board.device).expand(b, -1)
    runs = _closed_runs(board, cells, player + 1)
    return (board.reshape(b, -1) == 0) & (runs > 0).any(-1)


def move_result(board: torch.Tensor, action: torch.Tensor, player: torch.Tensor):
    """``(board, legal)`` after ``action`` ``[N]`` of ``player``
    (``othello.py::_move_result``)."""
    b = board.shape[0]
    me = player + 1
    a = action.long()
    runs = _closed_runs(board, a[:, None], me)[:, 0]                  # [N, 8]
    flat = board.reshape(b, -1)
    empty = flat[rows(flat), a] == 0
    legal = empty & (runs > 0).any(-1)
    sq = torch.arange(_N * _N, device=board.device)
    sr, sc = sq // _N, sq % _N
    r, c = (a // _N)[:, None], (a % _N)[:, None]
    flips = torch.zeros_like(flat, dtype=torch.bool)
    for d, (dr, dc) in enumerate(_DIRS):
        # squares (r + dr k, c + dc k) with 1 <= k <= the closed run
        kr = (sr - r) * dr if dr else None
        kc = (sc - c) * dc if dc else None
        k = kr if kr is not None else kc
        on_line = ((sr - r) == dr * k) & ((sc - c) == dc * k) & (k >= 1)
        flips = flips | (on_line & (k <= runs[:, d, None]))
    new = torch.where(flips, me[:, None], flat)
    new[rows(flat), a] = torch.where(legal, me, flat[rows(flat), a])
    return torch.where(legal[:, None], new, flat).reshape(board.shape).to(torch.int32), legal


class OthelloEnv(BoardEnv):
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
                "info:legal_moves": legal_mask(board, player)}

    def reset_env(self, draws):
        b = draws["rows"].shape[0]
        board = torch.zeros((b, _N, _N), dtype=torch.int32, device=self.device)
        board[:, 3, 3] = board[:, 4, 4] = 2
        board[:, 3, 4] = board[:, 4, 3] = 1
        player = torch.zeros(b, dtype=torch.int32, device=self.device)
        return {"board": board, "player": player}, self._obs(board, player)

    def step_env(self, state, action, draws):
        board, player = state["board"], state["player"]
        a = mover_action(action, player, self.max_num_players)
        new_board, legal = move_result(board, a, player)
        opp = 1 - player
        opp_can = legal_mask(new_board, opp).any(1)
        me_can = legal_mask(new_board, player).any(1)
        next_player = torch.where(opp_can, opp, player).to(torch.int32)
        game_over = ~opp_can & ~me_can
        illegal = ~legal
        terminated = game_over | illegal
        me_count = (new_board == (player + 1)[:, None, None]).flatten(1).sum(1)
        opp_count = (new_board == (2 - player)[:, None, None]).flatten(1).sum(1)
        outcome = torch.where(me_count > opp_count, 1.0,
                              torch.where(me_count < opp_count, -1.0, 0.0))
        mover_reward = torch.where(illegal, -1.0, torch.where(game_over, outcome, 0.0)).to(
            torch.float32)
        reward = per_player_reward(mover_reward, player, terminated, self.max_num_players)
        return EnvOut(state={"board": new_board, "player": next_player},
                      obs=self._obs(new_board, next_player), reward=reward,
                      terminated=terminated)
