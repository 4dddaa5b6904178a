"""Backgammon, batched over ``[N]`` boards.

Counterpart of ``envpool_tpu/envs/board/backgammon.py`` (reference
``envpool/pgx/backgammon.h``): 28 ints in the mover's frame (points 0..23
with the mover's checkers positive, 24 the mover's bar, 25 the
opponent's, 26 and 27 borne off), 156 actions = 26 sources x 6 dice, the
board flipped every turn, the win score (1, 2 gammon, 3 backgammon) to
the winner, -3 to a mover who plays an illegal action.

Draws, in JAX's order: the opening dice (a uniform die, then a uniform
other die of the five left) and the first player at the reset; two dice
at every step (used where the turn changes).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...ops.batched import first_argmax
from .common import BoardEnv, first_row_action, rows, seat_rewards

__all__ = ["BackgammonEnv"]

_INIT_BOARD = np.asarray([2, 0, 0, 0, 0, -5, 0, -3, 0, 0, 0, 5, -5, 0,
                          0, 0, 3, 0, 5, 0, 0, 0, 0, -2, 0, 0, 0, 0], np.int32)
_BAR, _OPP_BAR, _OFF, _OPP_OFF = 24, 25, 26, 27
_A = np.arange(156)
_SRC_CODE = _A // 6                    # 0 pass, 1 bar, 2..25 points
_DIE = _A % 6 + 1                      # pips 1..6
_SRC = np.where(_SRC_CODE == 1, _BAR, _SRC_CODE - 2)   # -2 for pass rows
_TO = _SRC + _DIE
_TGT = np.where(_SRC >= 24, _DIE - 1, np.where((_TO >= 0) & (_TO <= 23), _TO, _OFF))


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    t = {"src": _SRC, "src_code": _SRC_CODE, "die": _DIE, "tgt": _TGT, "init": _INIT_BOARD}
    return {k: torch.as_tensor(v, dtype=torch.int64 if k != "init" else torch.int32).to(device)
            for k, v in t.items()}


def legal_mask(board: torch.Tensor, allow_die: torch.Tensor) -> torch.Tensor:
    """``[N, 156]`` legal actions (``backgammon.py::_legal_mask``); where
    none is legal the six pass actions open up."""
    t = _tables(board.device)
    src, tgt, die, code = t["src"], t["tgt"], t["die"], t["src_code"]
    at_src = board[:, src.clamp(0, 27)]
    at_tgt = board[:, tgt.clamp(0, 27)]
    exists = at_src >= 1
    is_open = at_tgt >= -1
    to_point = (tgt >= 0) & (tgt <= 23) & (src >= 0)
    point_legal = torch.where(src >= 24, exists & is_open,
                              exists & is_open & (board[:, _BAR] == 0)[:, None])
    fwd = board[:, :24] > 0
    any_fwd = fwd.any(1)
    first = first_argmax(fwd.to(torch.int8))
    rear = torch.where(any_fwd, 24 - first, -76)[:, None]
    all_home = ((15 - board[:, _OFF]) == board[:, 18:24].clamp(0, 15).sum(1))[:, None]
    dist = 24 - src
    off_legal = ((src >= 0) & (src < 24) & exists & all_home
                 & ((dist == die) | ((rear <= die) & (rear == dist))))
    legal = (torch.where(to_point, point_legal, off_legal)
             & allow_die[:, die - 1] & (code != 0))
    none = ~legal.any(1, keepdim=True)
    return legal | (none & (torch.arange(156, device=board.device) < 6))


def _move(board: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    t = _tables(board.device)
    r = rows(board)
    a = action.long()
    src = torch.where(t["src_code"][a] == 1, _BAR, t["src_code"][a] - 2)
    tgt = t["tgt"][a]
    hit = board[r, tgt] == -1
    b = board.clone()
    b[:, _OPP_BAR] += torch.where(hit, -1, 0).to(b.dtype)
    b[r, src] -= 1
    b[r, tgt] += torch.where(hit, 2, 1).to(b.dtype)
    return b


def _flip(board: torch.Tensor) -> torch.Tensor:
    return torch.cat([-board[:, :24].flip(1),
                      -board[:, _OPP_BAR:_OPP_BAR + 1], -board[:, _BAR:_BAR + 1],
                      -board[:, _OPP_OFF:_OPP_OFF + 1], -board[:, _OFF:_OFF + 1]], 1)


def _playable_from_dice(dice: torch.Tensor) -> torch.Tensor:
    doubles = (dice[:, 0] == dice[:, 1])[:, None]
    minus = torch.full_like(dice, -1)
    return torch.where(doubles, dice[:, :1].expand(-1, 4), torch.cat([dice, minus], 1))


def _allow_from_playable(playable: torch.Tensor) -> torch.Tensor:
    return (playable[:, :, None] == torch.arange(6, device=playable.device)).any(1)


class BackgammonEnv(BoardEnv):
    def state_spec(self):
        return {
            "obs": ArraySpec(np.int32, (-1, 34)),
            "info:board": ArraySpec(np.int32, (28,)),
            "info:current_player": ArraySpec(np.int32, (), 0, 1),
            "info:dice": ArraySpec(np.int32, (2,), 0, 5),
            "info:legal_action_mask": ArraySpec(np.bool_, (156,)),
            "info:playable_dice": ArraySpec(np.int32, (4,), -1, 5),
            "info:played_dice_num": ArraySpec(np.int32, (), 0, 4),
            "info:turn": ArraySpec(np.int32, (), 0, 1),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, 155, is_discrete=True)}

    def plan_reset(self, d):
        d.randint("die0", 0, 6)
        d.randint("die1", 0, 5)
        d.randint("player", 0, 2)

    def plan_step(self, d):
        d.randint("dice", 0, 6, (2,))

    def _obs(self, st):
        six = torch.arange(6, device=st["board"].device)
        pl = st["playable"][:, :, None]
        dice_count = ((pl == six) & (pl >= 0)).sum(1).to(torch.int32)
        out = []
        for player in range(2):
            mine = (st["player"] == player)[:, None]
            out.append(torch.cat([st["board"], torch.where(mine, dice_count, 0)], 1))
        obs = torch.stack(out, 1)
        if self.max_num_players <= 1:
            obs = obs[:, 0]
        return {"obs": obs, "info:board": st["board"], "info:current_player": st["player"],
                "info:dice": st["dice"], "info:legal_action_mask": st["legal"],
                "info:playable_dice": st["playable"], "info:played_dice_num": st["played"],
                "info:turn": st["turn"]}

    def reset_env(self, draws):
        b = draws["rows"].shape[0]
        d0, d1 = draws["die0"], draws["die1"]
        dice = torch.stack([d0, d1 + (d1 >= d0).to(d1.dtype)], 1).to(torch.int32)
        playable = _playable_from_dice(dice)
        board = _tables(self.device)["init"].expand(b, 28).contiguous()
        st = {"board": board, "dice": dice, "playable": playable,
              "played": torch.zeros(b, dtype=torch.int32, device=self.device),
              "player": draws["player"].to(torch.int32),
              "turn": (dice[:, 1] > dice[:, 0]).to(torch.int32),
              "legal": legal_mask(board, _allow_from_playable(playable))}
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        t = _tables(state["board"].device)
        a = first_row_action(action, self.max_num_players).to(torch.int32).clamp(0, 155).long()
        r = rows(a)
        loser = state["player"]
        illegal = ~state["legal"][r, a]
        is_pass = t["src_code"][a] == 0
        board = torch.where(is_pass[:, None], state["board"], _move(state["board"], a))
        dice, playable0, played0 = state["dice"], state["playable"], state["played"]
        doubles = dice[:, 0] == dice[:, 1]
        slot = (3 - played0).clamp(0, 3).long()
        playable_dbl = playable0.clone()
        playable_dbl[r, slot] = -1
        die0 = (a % 6)[:, None]
        playable_non = torch.where(playable0 == die0, -1, playable0)
        playable = torch.where(is_pass[:, None], playable0,
                               torch.where(doubles[:, None], playable_dbl, playable_non))
        played = played0 + torch.where(is_pass, 0, 1).to(torch.int32)

        all_off = board[:, _OFF] == 15
        gammon = board[:, _OPP_OFF] == 0
        backgmn = gammon & (board[:, 18:24].sum(1) != 0)
        score = (1 + gammon.to(torch.int32) + backgmn.to(torch.int32)).to(torch.float32)

        turn_end = (playable == -1).all(1) | is_pass
        change = ~all_off & turn_end
        new_dice = draws["dice"].to(torch.int32)
        new_playable = _playable_from_dice(new_dice)
        c = change[:, None]
        board_out = torch.where(c, _flip(board), board)
        dice_out = torch.where(c, new_dice, dice)
        playable_out = torch.where(c, new_playable, playable)
        played_out = torch.where(change, 0, played).to(torch.int32)
        player_out = torch.where(change, 1 - loser, loser).to(torch.int32)
        turn_out = torch.where(change, (state["turn"] + 1) % 2, state["turn"]).to(torch.int32)
        allow = torch.where(c, _allow_from_playable(new_playable), _allow_from_playable(playable))
        legal_out = legal_mask(board_out, allow)
        terminated = all_off | illegal
        legal_out = legal_out | terminated[:, None]

        win = (-score)[:, None].expand(-1, 2).clone()
        win[r, loser.long()] = score
        ill = seat_rewards(loser, 3.0, -3.0)
        rewards = torch.where(illegal[:, None], ill,
                              torch.where(all_off[:, None], win, 0.0)).to(torch.float32)
        st = {"board": board_out, "dice": dice_out, "playable": playable_out,
              "played": played_out, "player": player_out, "turn": turn_out, "legal": legal_out}
        reward = rewards if self.max_num_players > 1 else rewards[r, loser.long()]
        return EnvOut(state=st, obs=self._obs(st), reward=reward, terminated=terminated)
