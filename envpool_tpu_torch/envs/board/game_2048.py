"""2048, batched over ``[N]`` boards.

Counterpart of ``envpool_tpu/envs/board/game_2048.py``: a 4x4 board of
tile exponents (0 empty); a move slides and merges along one of four
directions (0 left, 1 up, 2 right, 3 down), the reward is the sum of the
merged tiles' values, a random empty cell gets a 2 (p 0.9) or a 4 after
a move that changes the board, and the game ends when no move does.

Draws, in JAX's order: a spawn is a categorical pick over the 16 cells
(the first argmax of noise plus JAX's logits, 0 on empty cells and
``-inf`` elsewhere) and a uniform value; the reset spawns twice, the step
once (drawn whether or not the board changed).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...ops.batched import first_argmax
from .common import BoardEnv

__all__ = ["Game2048Env"]


def _compact(r: torch.Tensor) -> torch.Tensor:
    """The non-zero entries of each ``[M, 4]`` row moved left, in order."""
    key = torch.where(r > 0, 0, 1) * 4 + torch.arange(4, device=r.device)
    order = torch.argsort(key, dim=1)
    return r.gather(1, order)


def slide_left(rows4: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Slide and merge ``[M, 4]`` rows of exponents to the left:
    ``(rows, reward [M] float32)`` (``game_2048.py::_slide_row_left``)."""
    r = _compact(rows4)
    reward = torch.zeros(r.shape[0], dtype=torch.float32, device=r.device)
    cols = list(r.unbind(1))
    for i in range(3):
        # (a tile that just merged left a 0 behind it, so it cannot merge again)
        can = (cols[i] > 0) & (cols[i] == cols[i + 1])
        value = torch.bitwise_left_shift(torch.ones_like(cols[i]), cols[i] + 1)
        reward = reward + torch.where(can, value.to(torch.float32), 0.0)
        cols[i] = torch.where(can, cols[i] + 1, cols[i])
        cols[i + 1] = torch.where(can, 0, cols[i + 1])
    return _compact(torch.stack(cols, 1)), reward


def all_moves(board: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``([N, 4, 4, 4], [N, 4])``: the board and reward after each of the
    four moves (``game_2048.py::_move``)."""
    b = board.shape[0]
    views = (board, board.transpose(1, 2), board.flip(2), board.transpose(1, 2).flip(2))
    slid, rew = slide_left(torch.cat([v.reshape(-1, 4) for v in views]))
    slid = slid.reshape(4, b, 4, 4)
    rew = rew.reshape(4, b, 4).sum(2)
    boards = torch.stack([slid[0], slid[1].transpose(1, 2), slid[2].flip(2),
                          slid[3].flip(2).transpose(1, 2)], 1)
    return boards, rew.T


class Game2048Env(BoardEnv):
    def state_spec(self):
        return {"obs": ArraySpec(np.int32, (4, 4), 0, 16)}

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 3, is_discrete=True)}

    def plan_reset(self, d):
        for i in range(2):
            d.cells(f"cell{i}", 16)
            d.uniform(f"value{i}")

    def plan_step(self, d):
        d.cells("cell0", 16)
        d.uniform("value0")

    @staticmethod
    def _spawn(board, noise, u):
        b = board.shape[0]
        empty = (board == 0).reshape(b, -1)
        idx = first_argmax(noise + torch.where(empty, 0.0, float("-inf")))
        val = torch.where(u < 0.9, 1, 2).to(board.dtype)
        flat = board.reshape(b, -1).clone()
        spawned = flat.scatter(1, idx[:, None], val[:, None])
        return torch.where(empty.any(1)[:, None], spawned, flat).reshape(board.shape)

    def reset_env(self, draws):
        b = draws["rows"].shape[0]
        board = torch.zeros((b, 4, 4), dtype=torch.int32, device=self.device)
        board = self._spawn(board, draws["cell0"], draws["value0"])
        board = self._spawn(board, draws["cell1"], draws["value1"])
        return board, {"obs": board}

    def step_env(self, state, action, draws):
        boards, rewards = all_moves(state)
        a = action.long()
        r = torch.arange(state.shape[0], device=state.device)
        new_board, reward = boards[r, a], rewards[r, a]
        changed = (new_board != state).flatten(1).any(1)
        new_board = torch.where(changed[:, None, None],
                                self._spawn(new_board, draws["cell0"], draws["value0"]), state)
        after, _ = all_moves(new_board)
        terminated = ~(after != new_board[:, None]).flatten(2).any(2).any(1)
        return EnvOut(state=new_board, obs={"obs": new_board},
                      reward=torch.where(changed, reward, 0.0).to(torch.float32),
                      terminated=terminated)
