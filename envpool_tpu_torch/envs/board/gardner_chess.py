"""Gardner minichess (5x5), batched over ``[N]`` boards.

Counterpart of ``envpool_tpu/envs/board/gardner_chess.py`` (pgx surface):
obs ``(5, 5, 115)``, 1225 actions = 25 from-squares x 49 planes (32 queen
rides, 8 knight jumps, 9 underpromotions); no castling, no double push,
no en passant.  The position hashes are JAX's uint32 words kept as int32
of the same bits (``chess.py``'s note); the tables come from the same
``np.random.default_rng`` seed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...ops.batched import const, first_argmax
from .chess import insufficient_material, repetitions
from .chess_rules import B, Geometry, K, N, P, Q, R
from .common import BoardEnv, first_row_action, rows, seat_rewards, u32_table, uint32_hash

__all__ = ["GardnerChessEnv", "legal_action_mask", "apply_action", "board_hash"]

_N = 5
_NSQ = 25
_NPLANE = 49
NUM_ACTIONS = _NSQ * _NPLANE  # 1225
GEO = Geometry(_N)

_INIT_BOARD = np.zeros(_NSQ, np.int8)
_INIT_BOARD[:5] = [R, N, B, Q, K]
_INIT_BOARD[5:10] = P
_INIT_BOARD[15:20] = -P
_INIT_BOARD[20:25] = [-R, -N, -B, -Q, -K]

_HIST = 8
_REP_HIST = 101
_rng = np.random.default_rng(5050)
_HASH_PIECE = _rng.integers(1, 2**32, size=(13, _NSQ), dtype=np.uint32)


@functools.lru_cache(maxsize=None)
def _hash_table(device: torch.device) -> torch.Tensor:
    return u32_table(_HASH_PIECE).to(device)


def board_hash(board: torch.Tensor) -> torch.Tensor:
    """``[...]`` int32: the bits of JAX's uint32 hash of boards ``[..., 25]``."""
    sq = torch.arange(_NSQ, device=board.device)
    return uint32_hash(_hash_table(board.device)[board.to(torch.int64) + 6, sq])


def legal_action_mask(board: torch.Tensor) -> torch.Tensor:
    """``[N, 1225]`` legality in the mover's frame."""
    mask, _ = GEO.pseudo_mask(board, False)
    return mask.reshape(board.shape[0], -1)


def apply_action(board: torch.Tensor, action: torch.Tensor):
    """``(board, capture or pawn move)`` after ``action`` ``[N]``."""
    t = GEO.on(board.device)
    r = rows(board)
    a = action.long()
    from_sq, plane = a // _NPLANE, a % _NPLANE
    to = t["to_sq"][from_sq, plane].clamp(0, _NSQ - 1)
    pc = board[r, from_sq]
    is_under = t["is_under"][plane]
    promo_q = (pc == P) & (to // _N == _N - 1) & ~is_under
    new_piece = torch.where(is_under, t["under_piece"][plane],
                            torch.where(promo_q, Q, pc.long()))
    captured = board[r, to]
    b = board.clone()
    b[r, from_sq] = 0
    b[r, to] = new_piece.to(board.dtype)
    return b, (captured != 0) | (pc == P)


def flip(board: torch.Tensor) -> torch.Tensor:
    return (-board.reshape(-1, _N, _N).flip(1).reshape(board.shape)).to(board.dtype)


class GardnerChessEnv(BoardEnv):
    """GardnerChess-v1 (pgx surface)."""

    DEFAULT_CONFIG = {"max_termination_steps": 256}

    def state_spec(self):
        return {
            "obs": ArraySpec(np.float32, (-1, _N, _N, 115)),
            "info:board": ArraySpec(np.int32, (_N, _N)),
            "info:current_player": ArraySpec(np.int32, (), 0, 1),
            "info:fullmove_count": ArraySpec(np.int32, ()),
            "info:halfmove_count": ArraySpec(np.int32, ()),
            "info:legal_action_mask": ArraySpec(np.bool_, (NUM_ACTIONS,)),
            "info:turn": ArraySpec(np.int32, (), 0, 1),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, NUM_ACTIONS - 1, is_discrete=True)}

    def plan_reset(self, d):
        d.perm("seats", 2)

    def _obs(self, st):
        hist = st["hist"]                                              # [N, 8, 25]
        n = hist.shape[0]
        pieces = torch.arange(1, 7, device=hist.device, dtype=hist.dtype)
        own = hist[..., None] == pieces
        opp = hist[..., None] == -pieces
        reps = repetitions(st["rep_hash"], st["rep_len"], board_hash(hist))
        rep_planes = torch.stack([reps >= 2, reps >= 3], -1)[:, :, None, :].expand(
            n, _HIST, _NSQ, 2)
        per_t = torch.cat([own, opp, rep_planes], -1).to(torch.float32)
        per_t = per_t.permute(0, 2, 1, 3).reshape(n, _NSQ, _HIST * 14)
        tail = torch.stack([st["turn"].to(torch.float32) % 2, st["fullmove"].to(torch.float32),
                            st["halfmove"].to(torch.float32)], 1)
        obs = torch.cat([per_t, tail[:, None, :].expand(n, _NSQ, 3)], -1).reshape(
            n, _N, _N, 115)
        if self.max_num_players > 1:
            obs = torch.stack([obs, obs], 1)
        return obs

    def _obs_dict(self, st, mask):
        r = rows(st["turn"])
        return {
            "obs": self._obs(st),
            "info:board": st["board"].to(torch.int32).reshape(-1, _N, _N),
            "info:current_player": st["shuffled"][r, (st["turn"] % 2).long()],
            "info:fullmove_count": st["fullmove"],
            "info:halfmove_count": st["halfmove"],
            "info:legal_action_mask": mask,
            "info:turn": st["turn"] % 2,
        }

    def reset_env(self, draws):
        n = draws["rows"].shape[0]
        dev = self.device
        board = const(tuple(_INIT_BOARD.tolist()), dev, torch.int8).expand(n, _NSQ).contiguous()
        zero = torch.zeros(n, dtype=torch.int32, device=dev)
        rep_hash = torch.zeros((n, _REP_HIST), dtype=torch.int32, device=dev)
        rep_hash[:, 0] = board_hash(board)
        st = {"board": board, "turn": zero, "halfmove": zero, "fullmove": zero + 1,
              "ply": zero, "shuffled": draws["seats"].to(torch.int32),
              "hist": board[:, None].expand(n, _HIST, _NSQ).contiguous(),
              "rep_hash": rep_hash, "rep_len": zero + 1}
        return st, self._obs_dict(st, legal_action_mask(board))

    def step_env(self, state, action, draws):
        st = state
        a = first_row_action(action, self.max_num_players).to(torch.int32).clamp(
            0, NUM_ACTIONS - 1).long()
        r = rows(a)
        mover = st["shuffled"][r, (st["turn"] % 2).long()]
        illegal = ~legal_action_mask(st["board"])[r, a]
        board, zero_clock = apply_action(st["board"], a)
        next_board = flip(board)
        halfmove = torch.where(zero_clock, 0, st["halfmove"] + 1).to(torch.int32)
        fullmove = (st["fullmove"] + st["turn"] % 2).to(torch.int32)
        turn = (st["turn"] + 1).to(torch.int32)
        h = board_hash(next_board)
        rep_len = torch.where(zero_clock, 0, st["rep_len"].clamp(max=_REP_HIST - 1))
        rep_hash = torch.roll(torch.where(zero_clock[:, None], 0, st["rep_hash"]), 1, dims=1)
        rep_hash[:, 0] = h
        rep_len = (rep_len + 1).to(torch.int32)
        st2 = {"board": next_board, "turn": turn, "halfmove": halfmove, "fullmove": fullmove,
               "ply": (st["ply"] + 1).to(torch.int32), "shuffled": st["shuffled"],
               "hist": torch.cat([next_board[:, None], st["hist"][:, :-1]], 1),
               "rep_hash": rep_hash, "rep_len": rep_len}
        next_mask = legal_action_mask(next_board)
        no_moves = ~next_mask.any(1)
        king_sq = first_argmax((next_board == K).to(torch.int8))
        in_check = GEO.attacked_by_them(next_board)[r, king_sq]
        checkmate = no_moves & in_check
        draw = ((no_moves & ~in_check) | (halfmove >= 100)
                | (repetitions(rep_hash, rep_len, h) >= 3) | insufficient_material(next_board)
                | (st2["ply"] >= int(self.config["max_termination_steps"])))
        done = checkmate | draw | illegal
        loser = st["shuffled"][r, (turn % 2).long()]
        mate = torch.zeros((a.shape[0], 2), dtype=torch.float32, device=a.device)
        mate[r, mover.long()] = 1.0
        mate[r, loser.long()] = -1.0
        rewards = torch.where(checkmate[:, None], mate, 0.0)
        rewards = torch.where(illegal[:, None], seat_rewards(mover, 1.0, -1.0), rewards)
        next_mask = next_mask | done[:, None]
        reward = rewards if self.max_num_players > 1 else rewards[r, mover.long()]
        return EnvOut(state=st2, obs=self._obs_dict(st2, next_mask), reward=reward,
                      terminated=done)
