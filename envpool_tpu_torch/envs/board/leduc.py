"""Leduc hold'em, batched over ``[N]`` tables.

Counterpart of ``envpool_tpu/envs/board/leduc.py``: a 6-card deck (J, Q,
K in two suits; rank = card // 2), one private card each and one public
card, two betting rounds (raise 2, then 4; at most 2 raises a round);
actions 0 call/check, 1 raise, 2 fold; an illegal action counts as a
call.  The deal is the first three cards of a uniform permutation of the
six (a stable argsort of random words; the tests hand in JAX's).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from .common import BoardEnv, mover_action, rows, take

__all__ = ["LeducHoldemEnv"]


class LeducHoldemEnv(BoardEnv):
    def state_spec(self):
        return {
            "obs:card": ArraySpec(np.int32, (), 0, 2),
            "obs:public_card": ArraySpec(np.int32, (), 0, 3),  # 3 = hidden
            "obs:chips": ArraySpec(np.int32, (2,), 0, 13),  # [mine, opp]
            "obs:round": ArraySpec(np.int32, (), 0, 1),
            "obs:current_player": ArraySpec(np.int32, (), 0, 1, is_discrete=True),
            "info:legal_moves": ArraySpec(np.bool_, (3,)),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, 2, is_discrete=True)}

    def plan_reset(self, d):
        d.perm("deal", 6)

    @staticmethod
    def _legal(st):
        p = st["player"]
        mine, theirs = take(st["bets"], p), take(st["bets"], 1 - p)
        return torch.stack([torch.ones_like(p, dtype=torch.bool), st["raises"] < 2,
                            theirs > mine], 1)

    def _obs(self, st):
        p = st["player"]
        return {
            "obs:card": take(st["cards"], p),
            "obs:public_card": torch.where(st["round"] > 0, st["cards"][:, 2], 3),
            "obs:chips": torch.stack([take(st["bets"], p), take(st["bets"], 1 - p)], 1),
            "obs:round": st["round"],
            "obs:current_player": p,
            "info:legal_moves": self._legal(st),
        }

    def reset_env(self, draws):
        b = draws["rows"].shape[0]
        zero = torch.zeros(b, dtype=torch.int32, device=self.device)
        st = {"cards": (draws["deal"][:, :3] // 2).to(torch.int32),
              "bets": torch.ones((b, 2), dtype=torch.int32, device=self.device),
              "round": zero, "raises": zero, "acted": zero, "player": zero}
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        p = state["player"]
        a = mover_action(action, p, self.max_num_players)
        legal = self._legal(state)
        a = torch.where(take(legal, a.clamp(0, 2)), a, 0)
        cards, bets = state["cards"], state["bets"]
        rnd, raises, acted = state["round"], state["raises"], state["acted"]
        is_fold, is_raise = a == 2, a == 1
        raise_amt = torch.where(rnd == 0, 2, 4)
        mine, theirs = take(bets, p), take(bets, 1 - p)
        new_bet_p = torch.where(is_raise, theirs + raise_amt, torch.maximum(mine, theirs))
        new_bets = bets.clone()
        new_bets[rows(p), p.long()] = torch.where(is_fold, mine, new_bet_p).to(torch.int32)
        new_raises = raises + is_raise.to(torch.int32)
        new_acted = acted + 1
        round_over = ~is_fold & ~is_raise & (acted >= 1)
        to_showdown = round_over & (rnd == 1)
        to_round2 = round_over & (rnd == 0)
        terminated = is_fold | to_showdown
        pub = cards[:, 2]
        s0 = torch.where(cards[:, 0] == pub, 10 + cards[:, 0], cards[:, 0])
        s1 = torch.where(cards[:, 1] == pub, 10 + cards[:, 1], cards[:, 1])
        showdown_winner = torch.where(s0 > s1, 0, torch.where(s1 > s0, 1, -1))
        winner = torch.where(is_fold, 1 - p, showdown_winner)
        st = {
            "cards": cards,
            "bets": new_bets,
            "round": torch.where(to_round2, 1, rnd).to(torch.int32),
            "raises": torch.where(to_round2, 0, new_raises).to(torch.int32),
            "acted": torch.where(to_round2, 0, new_acted).to(torch.int32),
            "player": torch.where(terminated, p, torch.where(to_round2, 0, 1 - p)).to(
                torch.int32),
        }
        loser = 1 - winner
        # (JAX clamps the gather of a split pot's loser, 2, to 1)
        win = torch.where(winner < 0, 0, take(new_bets, loser.clamp(0, 1))).to(torch.float32)
        scored = terminated & (winner >= 0)
        if self.max_num_players > 1:
            w = winner.clamp(min=0)
            out = torch.zeros((p.shape[0], self.max_num_players), dtype=torch.float32,
                              device=p.device)
            out[rows(p), w] = win
            out[rows(p), 1 - w] = -win
            reward = torch.where(scored[:, None], out, 0.0)
        else:
            reward = torch.where(scored, torch.where(winner == p, win, -win), 0.0).to(
                torch.float32)
        return EnvOut(state=st, obs=self._obs(st), reward=reward, terminated=terminated)
