"""Animal Shogi (Dobutsu shogi), batched over ``[N]`` boards.

Counterpart of ``envpool_tpu/envs/board/animal_shogi.py`` (reference
``envpool/pgx/animal_shogi.h``).  A 3x4 board flattened as ``sq = x * 4
+ y``; pieces 0..4 the mover's pawn, bishop, rook, king and gold, 5..9
the opponent's, -1 empty.  132 actions = 11 x 12: ``label // 12`` < 8 a
direction from square ``label % 12``, >= 8 a drop of hand piece
``label // 12 - 8``.  The board flips every ply; the reference's history
rolls its flat boards by eight elements a ply, and so does the port.
The first player is drawn at the reset (the tests hand in JAX's draw).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...ops.batched import first_argmin
from .common import BoardEnv, first_row_action, rows, seat_rewards

__all__ = ["AnimalShogiEnv"]

_EMPTY, _PAWN, _BISHOP, _ROOK, _KING, _GOLD = -1, 0, 1, 2, 3, 4
_MAX_STEPS = 256
_INIT_BOARD = np.asarray([6, -1, -1, 2, 8, 5, 0, 3, 7, -1, -1, 1], np.int32)
_DX = np.asarray([-1, -1, -1, 0, 0, 1, 1, 1])
_DY = np.asarray([-1, 0, 1, -1, 1, -1, 0, 1])


def _can_move_table():
    """can[piece, from, to] (animal_shogi.h:81-103)."""
    can = np.zeros((5, 12, 12), bool)
    for frm in range(12):
        x0, y0 = frm // 4, frm % 4
        for to in range(12):
            x1, y1 = to // 4, to % 4
            dx, dy = x1 - x0, y1 - y0
            neigh = (dx or dy) and abs(dx) <= 1 and abs(dy) <= 1
            can[_PAWN, frm, to] = dx == 0 and dy == -1
            can[_BISHOP, frm, to] = neigh and (dx == dy or dx == -dy)
            can[_ROOK, frm, to] = neigh and (dx == 0 or dy == 0)
            can[_KING, frm, to] = bool(neigh)
            can[_GOLD, frm, to] = neigh and (dx == 0 or dy != 1)
    return can


_CAN = _can_move_table()
_LBL = np.arange(132)
_X = _LBL // 12
_SQ = _LBL % 12
_IS_DROP = _X >= 8
_DROP_PIECE = np.where(_IS_DROP, _X - 8, -1)
_FROM = np.where(_IS_DROP, -1, _SQ)
_nx = _SQ // 4 + _DX[np.minimum(_X, 7)]
_ny = _SQ % 4 + _DY[np.minimum(_X, 7)]
_TO_MOVE = np.where((_nx >= 0) & (_nx < 3) & (_ny >= 0) & (_ny < 4), _nx * 4 + _ny, -1)
_TO = np.where(_IS_DROP, _SQ, _TO_MOVE)
_ROW = _SQ[:12] % 4
_COL = 2 - _SQ[:12] // 4
_SQ_OF_RC = np.zeros((4, 3), np.int32)
for _s in range(12):
    _SQ_OF_RC[_s % 4, 2 - _s // 4] = _s


@functools.lru_cache(maxsize=None)
def _t(device: torch.device) -> dict:
    long = {"can": _CAN.astype(np.int64), "frm0": np.where(_IS_DROP, 0, np.maximum(_FROM, 0)),
            "to": np.clip(_TO, 0, 11), "drop_piece": np.maximum(_DROP_PIECE, 0),
            "frm": np.maximum(_FROM, 0), "sq_of_rc": _SQ_OF_RC.reshape(-1), "row": _ROW,
            "col": _COL}
    out = {k: torch.as_tensor(v, dtype=torch.int64).to(device) for k, v in long.items()}
    out["can"] = out["can"].bool()
    out["is_drop"] = torch.as_tensor(_IS_DROP).to(device)
    out["to_ok"] = torch.as_tensor(_TO >= 0).to(device)
    out["init"] = torch.as_tensor(_INIT_BOARD).to(device)
    return out


def is_checked(boards: torch.Tensor) -> torch.Tensor:
    """``[..., 12]`` boards -> whether the mover's king is attacked
    (animal_shogi.h:352-369)."""
    t = _t(boards.device)
    king_pos = first_argmin((boards - _KING).abs())
    pm = (boards % 5).clamp(0, 4)
    frm = torch.arange(12, device=boards.device)
    reach = t["can"][pm, king_pos[..., None], frm]
    return ((boards >= 5) & reach).any(-1)


def apply_moves(board: torch.Tensor, hand: torch.Tensor):
    """``([N, 132, 12], [N, 132, 2, 3])``: board and hand after every label
    (animal_shogi.h:272-293)."""
    t = _t(board.device)
    frm, to, is_drop, drop_piece = t["frm0"], t["to"], t["is_drop"], t["drop_piece"]
    piece = board[:, frm]                                             # [N, 132]
    promoted = torch.where((frm % 4 == 1) & (piece == _PAWN), _GOLD, piece)
    captured = board[:, to]
    hand_idx = ((captured % 5) % 4).clamp(0, 2)
    gain = torch.where((captured != _EMPTY) & (((captured % 5) % 4) < 3), 1, 0)
    n = board.shape[0]
    b = board[:, None, :].expand(n, 132, 12).clone()
    lbl = torch.arange(132, device=board.device)
    at_frm = b[:, lbl, frm]
    b[:, lbl, frm] = torch.where(is_drop, at_frm, _EMPTY).to(b.dtype)
    b[:, lbl, to] = torch.where(is_drop, drop_piece, promoted).to(b.dtype)
    h = hand[:, None].expand(n, 132, 2, 3).clone()
    r = rows(board)[:, None]
    h[r, lbl, 0, hand_idx] += torch.where(is_drop, 0, gain).to(h.dtype)
    h[r, lbl, 0, drop_piece] += torch.where(is_drop, -1, 0).to(h.dtype)
    return b, h


def legal_mask(board: torch.Tensor, hand: torch.Tensor) -> torch.Tensor:
    """``[N, 132]`` legal labels (animal_shogi.h:371-398)."""
    t = _t(board.device)
    boards_after, _ = apply_moves(board, hand)
    checked_after = is_checked(boards_after)
    frm, to = t["frm"], t["to"]
    piece = board[:, frm]
    dest = board[:, to]
    move_ok = (~t["is_drop"] & t["to_ok"] & (piece >= _PAWN) & (piece <= _GOLD)
               & ((dest == _EMPTY) | (dest > _GOLD)) & t["can"][piece.clamp(0, 4), frm, to])
    drop_ok = t["is_drop"] & (dest == _EMPTY) & (hand[:, 0, t["drop_piece"]] > 0)
    return (move_ok | drop_ok) & ~checked_after


def _flip_pieces(arr: torch.Tensor) -> torch.Tensor:
    return torch.where(arr != _EMPTY, (arr + 5) % 10, arr)


class AnimalShogiEnv(BoardEnv):
    def state_spec(self):
        return {
            "obs": ArraySpec(np.float32, (-1, 4, 3, 194)),
            "info:board": ArraySpec(np.int32, (4, 3), -1, 9),
            "info:current_player": ArraySpec(np.int32, (), 0, 1),
            "info:hand": ArraySpec(np.int32, (2, 3)),
            "info:legal_action_mask": ArraySpec(np.bool_, (132,)),
            "info:turn": ArraySpec(np.int32, (), 0, 1),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, 131, is_discrete=True)}

    def plan_reset(self, d):
        d.randint("player", 0, 2)

    def _obs_player(self, st, player):
        t = _t(st["board"].device)
        n = st["board"].shape[0]
        bh, hh = st["board_hist"], st["hand_hist"]
        mine = (player == st["player"])[:, None]
        color = torch.where(mine[:, 0], st["turn"], 1 - st["turn"])
        bh_flip = _flip_pieces(bh).reshape(n, 8, 12).flip(2).reshape(n, 96)
        hh_flip = torch.roll(hh.reshape(n, 8, 6), 3, dims=2).reshape(n, 48)
        bh = torch.where(mine, bh, bh_flip).reshape(n, 8, 12)
        hh = torch.where(mine, hh, hh_flip).reshape(n, 8, 6)
        planes = bh[..., None] == torch.arange(10, device=bh.device)     # [N, 8, 12, 10]
        piece_planes = planes.permute(0, 1, 3, 2).to(torch.float32)      # [N, 8, 10, 12]
        grid = torch.zeros((n, 8, 10, 4, 3), dtype=torch.float32, device=bh.device)
        grid[:, :, :, t["row"], t["col"]] = piece_planes
        hand_planes = torch.stack([hh >= 1, hh >= 2], -1).to(torch.float32)  # [N, 8, 6, 2]
        hand_grid = hand_planes.reshape(n, 8, 12, 1, 1).expand(n, 8, 12, 4, 3)
        rep = st["rep_hist"][..., None] == torch.arange(2, device=bh.device)
        rep_grid = rep.to(torch.float32)[..., None, None].expand(n, 8, 2, 4, 3)
        per_hist = torch.cat([grid, hand_grid, rep_grid], 2)             # [N, 8, 24, 4, 3]
        steps = (st["steps"].to(torch.float32) / np.float32(_MAX_STEPS))
        tail = torch.stack([color.to(torch.float32)[:, None, None].expand(n, 4, 3),
                            steps[:, None, None].expand(n, 4, 3)], 1)
        full = torch.cat([per_hist.reshape(n, 192, 4, 3), tail], 1)
        return full.permute(0, 2, 3, 1)

    def _obs(self, st):
        t = _t(st["board"].device)
        board_rc = st["board"][:, t["sq_of_rc"]].reshape(-1, 4, 3)
        obs = torch.stack([self._obs_player(st, p) for p in range(2)], 1)
        if self.max_num_players <= 1:
            obs = obs[:, 0]
        return {"obs": obs, "info:board": board_rc, "info:current_player": st["player"],
                "info:hand": st["hand"], "info:legal_action_mask": st["legal"],
                "info:turn": st["turn"]}

    def reset_env(self, draws):
        n = draws["rows"].shape[0]
        dev = self.device
        board = _t(dev)["init"].expand(n, 12).contiguous()
        hand = torch.zeros((n, 2, 3), dtype=torch.int32, device=dev)
        bh = torch.full((n, 96), _EMPTY, dtype=torch.int32, device=dev)
        bh[:, :12] = board
        zero = torch.zeros(n, dtype=torch.int32, device=dev)
        st = {"board": board, "hand": hand, "board_hist": bh,
              "hand_hist": torch.zeros((n, 48), dtype=torch.int32, device=dev),
              "rep_hist": torch.zeros((n, 8), dtype=torch.int32, device=dev),
              "player": draws["player"].to(torch.int32), "turn": zero, "steps": zero,
              "legal": legal_mask(board, hand)}
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        a = first_row_action(action, self.max_num_players).to(torch.int32).clamp(0, 131).long()
        st = state
        r = rows(a)
        n = a.shape[0]
        loser = st["player"]
        illegal = ~st["legal"][r, a]
        boards_after, hands_after = apply_moves(st["board"], st["hand"])
        board = boards_after[r, a]
        hand = hands_after[r, a]
        steps = st["steps"] + 1
        is_try = (board[:, 0] == _KING) | (board[:, 4] == _KING) | (board[:, 8] == _KING)
        bh = torch.roll(st["board_hist"], 8, dims=1)
        bh[:, :12] = board
        hh = torch.roll(st["hand_hist"], 8, dims=1)
        hh[:, :3] = hand[:, 0]
        hh[:, 3:6] = hand[:, 1]
        board = _flip_pieces(board).flip(1)
        hand = hand.flip(1)
        bh = _flip_pieces(bh).reshape(n, 8, 12).flip(2).reshape(n, 96)
        hh = torch.roll(hh.reshape(n, 8, 6), 3, dims=2).reshape(n, 48)
        player = 1 - st["player"]
        turn = 1 - st["turn"]
        same_board = (bh.reshape(n, 8, 12) == board[:, None]).all(-1)
        hand_flat = hand.reshape(n, 6)
        same_hand = (hh.reshape(n, 8, 6) == hand_flat[:, None]).all(-1)
        rep = ((same_board & same_hand).sum(1) - 1).to(torch.int32)
        is_rep_draw = rep >= 2
        legal = legal_mask(board, hand)
        done = ~legal.any(1) | is_try | is_rep_draw | (steps >= _MAX_STEPS)
        win = done & ~is_rep_draw & (steps < _MAX_STEPS)
        win_rewards = seat_rewards(player, 1.0, -1.0)
        ill_rewards = seat_rewards(loser, 1.0, -1.0)
        rewards = torch.where(illegal[:, None], ill_rewards,
                              torch.where(win[:, None], win_rewards, 0.0)).to(torch.float32)
        terminated = done | illegal
        rep_hist = torch.roll(st["rep_hist"], 1, dims=1)
        rep_hist[:, 0] = rep
        legal = legal | terminated[:, None]
        new = {"board": board, "hand": hand, "board_hist": bh, "hand_hist": hh,
               "rep_hist": rep_hist, "player": player.to(torch.int32),
               "turn": turn.to(torch.int32), "steps": steps.to(torch.int32), "legal": legal}
        reward = rewards if self.max_num_players > 1 else rewards[r, loser.long()]
        return EnvOut(state=new, obs=self._obs(new), reward=reward, terminated=terminated)
