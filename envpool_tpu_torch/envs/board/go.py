"""Go, batched over ``[N]`` boards.

Counterpart of ``envpool_tpu/envs/board/go.py`` (reference: the pgx
family's ``Go{9,13,19}x{..}-v1`` and ``ChineseGo*-v1``, komi 7.5).  The
state holds the chain labels (the least flat index of each same-coloured
chain; an empty point keeps its own index) and the liberty count of each
label, both equal to JAX's bit for bit: they are the fixpoint of its
min-label loops, which :func:`~.common.min_labels` reaches with pointer
jumping in about a log of the passes.  Legality is closed-form from the
liberties, captures remove the adjacent opponent chains in atari, simple
ko bans one point for a turn, and two passes end the game under
Tromp-Taylor area scoring (computed on every step, as JAX does).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...ops.batched import first_argmax
from .common import BoardEnv, min_labels, mover_action, per_player_reward, shift2d

__all__ = ["GoEnv", "chain_labels", "chain_liberties", "area_score"]

_DIRS = ((-1, 0), (1, 0), (0, -1), (0, 1))


def chain_labels(board: torch.Tensor) -> torch.Tensor:
    """``[N, n, n]`` int32: the least flat index of each same-coloured
    chain (``go.py::_chain_labels``)."""
    n = board.shape[-1]
    stone = board != 0
    links = [(dr, dc, (shift2d(board, dr, dc, -1) == board) & stone) for dr, dc in _DIRS]
    return min_labels(links, n * n)


def chain_liberties(board: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``[N, n * n]`` int32: each label's count of distinct empty points
    next to its chain (``go.py::_chain_liberties``)."""
    b, n = board.shape[0], board.shape[-1]
    sent = n * n
    empty = board == 0
    labs = [torch.where(empty & (shift2d(board, dr, dc, 0) != 0),
                        shift2d(labels, dr, dc, sent), sent) for dr, dc in _DIRS]
    dedup = []
    for i, lab in enumerate(labs):
        for j in range(i):  # one chain seen from two sides counts once
            lab = torch.where(lab == labs[j], sent, lab)
        dedup.append(lab.reshape(b, -1))
    idx = torch.cat(dedup, 1).long()
    libs = torch.zeros(b, sent + 1, dtype=torch.int32, device=board.device)
    libs.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    return libs[:, :-1]


def legal_points(board, labels, libs, mark, ko) -> torch.Tensor:
    """``[N, n * n]``: the points the player of ``mark`` may play
    (``go.py::_legal_points``)."""
    b, n = board.shape[0], board.shape[-1]
    empty = board == 0
    ok = torch.zeros_like(empty)
    m = mark[:, None, None]
    for dr, dc in _DIRS:
        nb_col = shift2d(board, dr, dc, -1)
        nb_lab = shift2d(labels, dr, dc, 0)
        nb_libs = libs.gather(1, nb_lab.reshape(b, -1).long()).reshape(board.shape)
        ok = ok | (nb_col == 0) | ((nb_col == 3 - m) & (nb_libs == 1)) | (
            (nb_col == m) & (nb_libs >= 2))
    flat = (empty & ok).reshape(b, -1)
    return flat & (torch.arange(n * n, device=board.device) != ko[:, None])


def area_score(board: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tromp-Taylor area ``(black, white)``, ``[N]`` int64 each: stones
    plus the empty regions that touch one colour only
    (``go.py::_area_score``)."""
    b, n = board.shape[0], board.shape[-1]
    sent = n * n
    empty = board == 0
    links = [(dr, dc, empty & shift2d(empty, dr, dc, False)) for dr, dc in _DIRS]
    labels = min_labels(links, sent)
    region = torch.where(empty, labels, sent).reshape(b, -1).long()
    touch = []
    for color in (1, 2):
        near = torch.zeros_like(empty)
        for dr, dc in _DIRS:
            near = near | shift2d(board == color, dr, dc, False)
        t = torch.zeros(b, sent + 1, dtype=torch.int32, device=board.device)
        t.scatter_reduce_(1, region, near.reshape(b, -1).to(torch.int32), "amax")
        touch.append(t.gather(1, labels.reshape(b, -1).long()).reshape(board.shape) > 0)
    black_terr = empty & touch[0] & ~touch[1]
    white_terr = empty & touch[1] & ~touch[0]
    black = (board == 1).flatten(1).sum(1) + black_terr.flatten(1).sum(1)
    white = (board == 2).flatten(1).sum(1) + white_terr.flatten(1).sum(1)
    return black, white


class GoEnv(BoardEnv):
    """N x N Go; action in ``[0, N * N]``, ``N * N`` passes; board 0/1/2 =
    empty/black/white."""

    DEFAULT_CONFIG = {
        "board_size": 19,
        "komi": 7.5,
        "history_length": 8,
        "max_terminal_steps": 0,
        "rules": "pgx",
    }

    @property
    def n(self) -> int:
        return int(self.config["board_size"])

    def state_spec(self):
        n = self.n
        return {
            "obs:board": ArraySpec(np.int32, (n, n), 0, 2),
            "obs:current_player": ArraySpec(np.int32, (), 0, 1, is_discrete=True),
            "info:legal_moves": ArraySpec(np.bool_, (n * n + 1,)),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, self.n * self.n, is_discrete=True)}

    def _obs(self, board, player, legal):
        ones = torch.ones(board.shape[0], 1, dtype=torch.bool, device=board.device)
        return {"obs:board": board, "obs:current_player": player,
                "info:legal_moves": torch.cat([legal, ones], 1)}  # pass is always legal

    def reset_env(self, draws):
        b, n = draws["rows"].shape[0], self.n
        dev = self.device
        board = torch.zeros((b, n, n), dtype=torch.int32, device=dev)
        zero = torch.zeros(b, dtype=torch.int32, device=dev)
        state = {
            "board": board,
            "player": zero,
            "ko": torch.full((b,), -1, dtype=torch.int32, device=dev),
            "passes": zero,
            "moves": zero,
            "labels": torch.arange(n * n, dtype=torch.int32, device=dev).reshape(1, n, n)
            .expand(b, n, n).contiguous(),
            "libs": torch.zeros((b, n * n), dtype=torch.int32, device=dev),
        }
        legal = torch.ones((b, n * n), dtype=torch.bool, device=dev)
        return state, self._obs(board, zero, legal)

    def step_env(self, state, action, draws):
        n = self.n
        board, player = state["board"], state["player"]
        labels, libs = state["labels"], state["libs"]
        b = board.shape[0]
        action = mover_action(action, player, self.max_num_players).clamp(0, n * n)
        is_pass = action == n * n
        mark = player + 1
        p = action.clamp(max=n * n - 1).long()
        legal_now = legal_points(board, labels, libs, mark, state["ko"])
        legal = is_pass | legal_now.gather(1, p[:, None])[:, 0]

        # -- play the stone (unconditionally; selected out below) ----------
        flat_idx = torch.arange(n * n, device=board.device)
        placed = (flat_idx == p[:, None]).reshape(b, n, n)
        adj_p = torch.zeros_like(placed)
        for dr, dc in _DIRS:
            adj_p = adj_p | shift2d(placed, dr, dc, False)
        lab_flat = labels.reshape(b, -1).long()
        adj_chain = torch.zeros(b, n * n + 1, dtype=torch.int32, device=board.device)
        adj_chain.scatter_reduce_(1, lab_flat,
                                  (adj_p & (board != 0)).reshape(b, -1).to(torch.int32), "amax")
        m = mark[:, None, None]
        captured = ((board == 3 - m)
                    & (libs.gather(1, lab_flat).reshape(board.shape) == 1)
                    & (adj_chain.gather(1, lab_flat).reshape(board.shape) > 0))
        board_played = torch.where(captured, 0, board)
        board_played = torch.where(placed, m, board_played)
        num_captured = captured.flatten(1).sum(1)
        cap_pos = first_argmax(captured.reshape(b, -1).to(torch.int8)).to(torch.int32)

        own_nbr = torch.zeros_like(placed)
        empty_after = torch.zeros(board.shape, dtype=torch.int32, device=board.device)
        for dr, dc in _DIRS:
            own_nbr = own_nbr | shift2d(board == m, dr, dc, False)
            empty_after = empty_after + shift2d(board_played == 0, dr, dc, False).to(torch.int32)
        lone = ~(own_nbr & placed).flatten(1).any(1)
        one_lib = torch.where(placed, empty_after, 0).flatten(1).sum(1) == 1
        ko_new = torch.where(~is_pass & (num_captured == 1) & lone & one_lib, cap_pos, -1)

        # -- merge pass / play / illegal -------------------------------------
        play = ~is_pass & legal
        new_board = torch.where(play[:, None, None], board_played, board)
        passes = torch.where(is_pass, state["passes"] + 1, 0).to(torch.int32)
        ko_new = torch.where(play, ko_new, -1).to(torch.int32)
        moves = state["moves"] + 1
        game_over = passes >= 2
        max_steps = int(self.config["max_terminal_steps"])
        if max_steps > 0:
            game_over = game_over | (moves >= max_steps)
        terminated = game_over | ~legal

        black, white = area_score(new_board)
        komi = float(self.config["komi"])
        margin = black.to(torch.float32) - white.to(torch.float32) - np.float32(komi)
        mover_margin = torch.where(mark == 1, margin, -margin)
        outcome = torch.sign(mover_margin)
        mover_reward = torch.where(~legal, -1.0, torch.where(game_over, outcome, 0.0)).to(
            torch.float32)
        reward = per_player_reward(mover_reward, player, terminated, self.max_num_players)

        next_player = torch.where(terminated, player, 1 - player).to(torch.int32)
        new_labels = chain_labels(new_board)
        new_libs = chain_liberties(new_board, new_labels)
        st = {"board": new_board, "player": next_player, "ko": ko_new, "passes": passes,
              "moves": moves.to(torch.int32), "labels": new_labels, "libs": new_libs}
        next_legal = legal_points(new_board, new_labels, new_libs, next_player + 1, ko_new)
        return EnvOut(state=st, obs=self._obs(new_board, next_player, next_legal),
                      reward=reward, terminated=terminated)
