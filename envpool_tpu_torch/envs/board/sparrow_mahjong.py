"""Sparrow Mahjong (suzume-jong), batched over ``[N]`` tables.

Counterpart of ``envpool_tpu/envs/board/sparrow_mahjong.py`` (reference
``envpool/pgx/sparrow_mahjong.h``): three players, 44 tiles of 11 types,
five-tile hands, one draw a turn, the action is the tile type to discard;
tsumo and ron (score >= 5, not furiten), the last wall tile the dora
indicator, an exhausted wall a tie; scores from the reference's 160-entry
winning-hand cache (``_WIN_HANDS``, ``_BASE_SCORES``, ``_YAKU_SCORES``,
copied), rewards score / 26 per player id.

Draws: the seats (a permutation of 3) and the wall (a permutation of
44), the first deal at the reset.  A deal whose dealer holds a completed
hand after the first draw is dealt again (the reference's do/while): JAX
redraws with ``fold_in`` keys inside a ``lax.while_loop``; the port
redraws only the rows still bad, from fresh slots of the same stream,
until none is, in :meth:`SparrowMahjongEnv.reset_draws`.  The reset
itself is a function of the final deal, so a test hands in JAX's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.rng import Draws
from ...core.specs import ArraySpec
from ...ops.batched import first_argmin
from .common import BoardEnv, first_row_action, rows

__all__ = ["SparrowMahjongEnv"]

_T = 11          # tile types
_N = 44          # tiles
_P = 3           # players
_RIVER = 10
_MAX_SCORE = 26.0

_WIN_HANDS = np.asarray([
    18, 78, 90, 378, 390, 450, 778, 790, 850, 1150, 1550, 1878, 1890,
    1950, 2250, 2650, 3878, 3890, 3950, 4250, 4650, 5750, 7750, 9378,
    9390, 9450, 9750, 10150, 11250, 13250, 19378, 19390, 19450, 19750,
    20150, 21250, 23250, 28750, 38750, 46878, 46890, 46950, 47250,
    47650, 48750, 50750, 56250, 66250, 96878, 96890, 96950, 97250,
    97650, 98750, 100750, 106250, 116250, 143750, 193750, 234378,
    234390, 234450, 234750, 235150, 236250, 238250, 243750, 253750,
    281250, 331250, 484378, 484390, 484450, 484750, 485150, 486250,
    488250, 493750, 503750, 531250, 581250, 718750, 968750, 1171878,
    1171890, 1171950, 1172250, 1172650, 1173750, 1175750, 1181250,
    1191250, 1218750, 1268750, 1406250, 1656250, 2421878, 2421890,
    2421950, 2422250, 2422650, 2423750, 2425750, 2431250, 2441250,
    2468750, 2518750, 2656250, 2906250, 3593750, 4843750, 5859378,
    5859390, 5859450, 5859750, 5860150, 5861250, 5863250, 5868750,
    5878750, 5906250, 5956250, 6093750, 6343750, 7031250, 8281250,
    12109378, 12109390, 12109450, 12109750, 12110150, 12111250,
    12113250, 12118750, 12128750, 12156250, 12206250, 12343750,
    12593750, 13281250, 14531250, 17968750, 24218750, 29296878,
    29296890, 29296950, 29297250, 29297650, 29298750, 29300750,
    29306250, 29316250, 29343750, 29393750, 29531250, 29781250,
    30468750, 31718750, 35156250, 41406250], np.int64)

_BASE_SCORES = np.asarray([
    4, 4, 4, 4, 4, 4, 3, 3, 3, 3, 2, 4, 4, 4, 4, 3, 3, 3, 3, 3, 2, 3,
    2, 4, 4, 4, 4, 3, 4, 3, 3, 3, 3, 3, 2, 3, 2, 3, 2, 4, 4, 4, 4, 3,
    4, 3, 4, 3, 3, 3, 3, 3, 2, 3, 2, 3, 2, 3, 2, 4, 4, 4, 4, 3, 4, 3,
    4, 3, 4, 3, 3, 3, 3, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 4, 4, 4, 4, 3,
    4, 3, 4, 3, 4, 3, 4, 3, 3, 3, 3, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3,
    2, 4, 4, 4, 4, 3, 4, 3, 4, 3, 4, 3, 4, 3, 4, 3, 3, 3, 3, 3, 2, 3,
    2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 4, 4, 4, 4, 3, 4, 3, 4, 3, 4, 3,
    4, 3, 4, 3, 4, 3], np.int32)

_YAKU_SCORES = np.asarray([
    15, 15, 15, 0, 10, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1,
    0, 1, 1, 0, 10, 0, 10, 0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 1, 0,
    0, 0, 1, 0, 1, 1, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 0,
    10, 0, 10, 0, 1, 1, 10, 1, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 1, 1,
    1, 1, 1, 0, 10, 0, 10, 0, 1, 1, 10, 1, 1, 1, 10, 1, 0, 10, 0, 10,
    0, 1, 1, 10, 1, 1, 1, 10, 1, 10, 10, 0, 10, 0, 10, 0, 1, 1, 10, 1,
    1, 1, 10, 1, 10, 10, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 15, 15, 15, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    np.int32)

_BASE5 = np.asarray([9765625, 1953125, 390625, 78125, 15625, 3125, 625,
                     125, 25, 5, 1], np.int64)
_IS_RED = np.asarray([(i % 4 == 0 and i != 36) or i >= 40
                      for i in range(_N)])




@functools.lru_cache(maxsize=None)
def _t(device: torch.device) -> dict:
    return {"win": torch.as_tensor(_WIN_HANDS).to(device),
            "base": torch.as_tensor(_BASE_SCORES).to(device),
            "yaku": torch.as_tensor(_YAKU_SCORES).to(device),
            "base5": torch.as_tensor(_BASE5).to(device),
            "red": torch.as_tensor(_IS_RED).to(device)}


def _to_base5(hand: torch.Tensor) -> torch.Tensor:
    return (hand.to(torch.int64) * _t(hand.device)["base5"]).sum(-1)


def is_completed(hand: torch.Tensor) -> torch.Tensor:
    """``[...]``: whether hands ``[..., 11]`` are in the winning cache."""
    return (_to_base5(hand)[..., None] == _t(hand.device)["win"]).any(-1)


def _hand_to_score(hand: torch.Tensor):
    """(base, yaku) of the nearest cache entry (sparrow_mahjong.h:121-134)."""
    t = _t(hand.device)
    ix = first_argmin((t["win"] - _to_base5(hand)[..., None]).abs())
    return t["base"][ix], t["yaku"][ix]


def hands_to_score(hands, n_red, dora, last_discard) -> torch.Tensor:
    """``[N, 3]`` potential score of each seat (sparrow_mahjong.h:312-336)."""
    discard = torch.where(last_discard >= 0, last_discard, 10).long()
    add = torch.nn.functional.one_hot(discard, _T).to(hands.dtype)      # [N, 11]
    full = hands + torch.where((hands.sum(-1) == 5)[..., None], add[:, None, :], 0)
    base, yaku = _hand_to_score(full)
    n_doras = full.gather(2, dora.long()[:, None, None].expand(-1, _P, 1))[..., 0]
    n_red_doras = n_red.sum(-1)
    yaku = torch.where(n_red_doras >= 6, 20, yaku)
    return torch.where(yaku >= 10, base + yaku, base + yaku + n_doras + n_red_doras).to(
        torch.int32)


def _draw(st: dict) -> dict:
    """The current seat draws the next wall tile; its discard mask
    (sparrow_mahjong.h:296-310)."""
    t = _t(st["wall"].device)
    r = rows(st["wall"])
    seat = (st["turn"] % _P).long()
    tid = st["wall"][r, st["draw_ix"].long().clamp(max=_N - 1)]
    tile = (tid // 4).long()
    hands = st["hands"].clone()
    hands[r, seat, tile] += 1
    n_red = st["n_red"].clone()
    n_red[r, seat, tile] += t["red"][tid.long()].to(n_red.dtype)
    return {**st, "hands": hands, "n_red": n_red, "draw_ix": (st["draw_ix"] + 1).to(torch.int32),
            "legal": hands[r, seat] > 0}


def deal(seats: torch.Tensor, wall: torch.Tensor) -> dict:
    """The state of a deal (``_deal`` without its redeal test)."""
    t = _t(wall.device)
    n = wall.shape[0]
    dev = wall.device
    seats_of = torch.arange(_P, device=dev).repeat_interleave(5)
    tiles = (wall[:, : _P * 5] // 4).long()
    hands = torch.zeros((n, _P, _T), dtype=torch.int32, device=dev)
    idx = seats_of * _T + tiles                                          # [N, 15]
    hands.view(n, -1).scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    n_red = torch.zeros((n, _P, _T), dtype=torch.int32, device=dev)
    n_red.view(n, -1).scatter_add_(1, idx, t["red"][wall[:, : _P * 5].long()].to(torch.int32))
    zero = torch.zeros(n, dtype=torch.int32, device=dev)
    st = {
        "wall": wall, "hands": hands, "n_red": n_red,
        "rivers": torch.full((n, _P, _RIVER), -1, dtype=torch.int32, device=dev),
        "red_river": torch.zeros((n, _P, _RIVER), dtype=torch.bool, device=dev),
        "shuffled": seats, "turn": zero, "last_discard": zero - 1,
        "dora": (wall[:, -1] // 4).to(torch.int32), "draw_ix": zero + _P * 5,
        "scores": torch.zeros((n, _P), dtype=torch.int32, device=dev),
        "legal": torch.zeros((n, _T), dtype=torch.bool, device=dev),
        "player": seats[:, 0],
    }
    return _draw(st)


class SparrowMahjongEnv(BoardEnv):
    def state_spec(self):
        return {
            "obs": ArraySpec(np.bool_, (-1, 11, 15)),
            "info:current_player": ArraySpec(np.int32, (), 0, 2),
            "info:dora": ArraySpec(np.int32, (), 0, 10),
            "info:draw_ix": ArraySpec(np.int32, (), 0, 44),
            "info:hands": ArraySpec(np.int32, (3, 11), 0, 6),
            "info:is_red_in_river": ArraySpec(np.bool_, (3, 10)),
            "info:last_discard": ArraySpec(np.int32, (), -1, 10),
            "info:legal_action_mask": ArraySpec(np.bool_, (11,)),
            "info:n_red_in_hands": ArraySpec(np.int32, (3, 11), 0, 4),
            "info:rivers": ArraySpec(np.int32, (3, 10), -1, 10),
            "info:scores": ArraySpec(np.int32, (3,)),
            "info:shuffled_players": ArraySpec(np.int32, (3,), 0, 2),
            "info:turn": ArraySpec(np.int32, ()),
            "info:wall": ArraySpec(np.int32, (44,), 0, 43),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, 10, is_discrete=True)}

    def plan_reset(self, d):
        d.perm("seats", _P)
        d.perm("wall", _N)

    def reset_draws(self, sub):
        """The first deal, and fresh deals for the rows whose dealer holds a
        completed hand after the first draw, until none does."""
        d = Draws(sub)
        self.plan_reset(d)
        out = d.out
        while True:
            bad = is_completed(deal(out["seats"], out["wall"])["hands"][:, 0])
            if not bool(bad.any()):
                return out
            seats, wall = d.perm("seats_again", _P), d.perm("wall_again", _N)
            out["seats"] = torch.where(bad[:, None], seats, out["seats"])
            out["wall"] = torch.where(bad[:, None], wall, out["wall"])

    def reset_env(self, draws):
        st = deal(draws["seats"].to(torch.int32), draws["wall"].to(torch.int32))
        return st, self._obs(st)

    def _obs_player(self, st, player_id: int) -> torch.Tensor:
        n = st["wall"].shape[0]
        dev = st["wall"].device
        r = rows(st["wall"])
        seat = first_argmin((st["shuffled"] != player_id).to(torch.int8))
        counts = st["hands"][r, seat]                                    # [N, 11]
        obs = torch.zeros((n, _T, 15), dtype=torch.bool, device=dev)
        obs[:, :, 0:4] = counts[:, :, None] >= torch.arange(1, 5, device=dev)
        obs[:, :, 4] = st["n_red"][r, seat] >= 1
        obs[r, st["dora"].long(), 5] = True
        tiles = torch.arange(_T, device=dev)
        for offset in range(_P):
            river = st["rivers"][r, (seat + offset) % _P]                # [N, 10]
            hit = (river[:, :, None] == tiles) & (river >= 0)[:, :, None]
            obs[:, :, 6 + offset] |= hit.any(1)
        for offset in (1, 2):
            river = st["rivers"][r, (seat + offset) % _P]
            count = (river >= 0).sum(1)
            for back in (1, 2, 3):
                idx = count - back
                tile = river[r, idx.clamp(0, _RIVER - 1)]
                ok = (idx >= 0) & (tile >= 0)
                feat = 9 + (offset - 1) * 3 + (back - 1)
                tc = tile.clamp(0, _T - 1).long()
                obs[r, tc, feat] = obs[r, tc, feat] | ok
        return obs

    def _obs(self, st):
        obs = torch.stack([self._obs_player(st, p) for p in range(_P)], 1)
        if self.max_num_players <= 1:
            obs = obs[:, 0]
        return {
            "obs": obs,
            "info:current_player": st["player"],
            "info:dora": st["dora"],
            "info:draw_ix": st["draw_ix"],
            "info:hands": st["hands"],
            "info:is_red_in_river": st["red_river"],
            "info:last_discard": st["last_discard"],
            "info:legal_action_mask": st["legal"],
            "info:n_red_in_hands": st["n_red"],
            "info:rivers": st["rivers"],
            "info:scores": st["scores"],
            "info:shuffled_players": st["shuffled"],
            "info:turn": st["turn"],
            "info:wall": st["wall"],
        }

    def step_env(self, state, action, draws):
        a = first_row_action(action, self.max_num_players).to(torch.int32).clamp(0, _T - 1)
        al = a.long()
        st = dict(state)
        r = rows(a)
        n = a.shape[0]
        loser = st["player"]
        illegal = ~st["legal"][r, al]
        seat = (st["turn"] % _P).long()

        # Discard (sparrow_mahjong.h:421-434).
        hands = st["hands"].clone()
        hands[r, seat, al] -= 1
        red_disc = hands[r, seat, al] < st["n_red"][r, seat, al]
        n_red = st["n_red"].clone()
        n_red[r, seat, al] -= red_disc.to(n_red.dtype)
        slot = (st["turn"] // _P).long()
        rivers = st["rivers"].clone()
        rivers[r, seat, slot] = a
        red_river = st["red_river"].clone()
        red_river[r, seat, slot] = red_disc
        st = {**st, "hands": hands, "n_red": n_red, "rivers": rivers, "red_river": red_river,
              "last_discard": a}

        scores_pot = hands_to_score(hands, n_red, st["dora"], a)
        # Ron (sparrow_mahjong.h:338-356).
        add = torch.nn.functional.one_hot(al, _T).to(hands.dtype)
        completed = is_completed(hands + add[:, None, :])
        furiten = (rivers == a[:, None, None]).any(-1)
        others = torch.arange(_P, device=a.device) != seat[:, None]
        winners = others & ~furiten & (scores_pot >= 5) & completed
        has_ron = winners.any(1)
        ron_scores = scores_pot.clone()
        ron_scores[:, 0] += 2
        ron_scores = torch.where(winners, ron_scores, 0)
        ron_scores[r, seat] = -ron_scores.sum(1).to(torch.int32)

        tie = (_N - 1) <= st["draw_ix"]

        # The next seat draws; tsumo.
        turn = (st["turn"] + 1).to(torch.int32)
        st_next = {**st, "turn": turn, "player": st["shuffled"][r, (turn % _P).long()]}
        st_next = _draw(st_next)
        nseat = (st_next["turn"] % _P).long()
        nscores = hands_to_score(st_next["hands"], st_next["n_red"], st["dora"],
                                 st["last_discard"])
        tsumo = is_completed(st_next["hands"][r, nseat])
        nscores[:, 0] += 2
        w = nscores[r, nseat]
        loser_pay = torch.div(w + _P - 2, _P - 1, rounding_mode="floor")
        tsumo_scores = (-loser_pay)[:, None].expand(n, _P).clone()
        tsumo_scores[r, nseat] = loser_pay * (_P - 1)

        done = has_ron | tie | (~has_ron & ~tie & tsumo) | illegal
        zeros = torch.zeros((n, _P), dtype=torch.int32, device=a.device)
        seat_scores = torch.where(has_ron[:, None], ron_scores, torch.where(
            tie[:, None], zeros, torch.where(tsumo[:, None], tsumo_scores, zeros))).to(
            torch.int32)
        # Seat scores to player ids (RewardsFromScores); XLA computes
        # x / 26 as x * (1 / 26).
        by_player = torch.zeros((n, _P), dtype=torch.float32, device=a.device)
        by_player[r[:, None], st["shuffled"].long()] = (
            seat_scores.to(torch.float32) * np.float32(1 / _MAX_SCORE))
        ill = torch.ones((n, _P), dtype=torch.float32, device=a.device)
        ill[r, loser.long()] = -1.0
        rewards = torch.where(illegal[:, None], ill, torch.where(
            (has_ron | (~tie & tsumo))[:, None], by_player, 0.0))

        cont = ~has_ron & ~tie
        out = {k: torch.where(cont.reshape(-1, *[1] * (st[k].ndim - 1)), st_next[k], st[k])
               for k in st}
        out["scores"] = torch.where((done & ~illegal)[:, None], seat_scores, out["scores"])
        out["legal"] = out["legal"] | done[:, None]
        reward = rewards if self.max_num_players > 1 else rewards[r, loser.long()]
        return EnvOut(state=out, obs=self._obs(out), reward=reward, terminated=done)
