"""Kuhn poker, batched over ``[N]`` tables.

Counterpart of ``envpool_tpu/envs/board/poker.py``: three cards (J 0,
Q 1, K 2), each player antes 1 and gets one card; actions 0 pass
(check/fold), 1 bet (call).  The deal is a uniform permutation of the
three cards (a stable argsort of random words; the tests hand in JAX's).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from .common import BoardEnv, mover_action, rows, take

__all__ = ["KuhnPokerEnv"]


class KuhnPokerEnv(BoardEnv):
    def state_spec(self):
        return {
            "obs:card": ArraySpec(np.int32, (), 0, 2),
            "obs:history": ArraySpec(np.int32, (3,), 0, 1),
            "obs:current_player": ArraySpec(np.int32, (), 0, 1, is_discrete=True),
        }

    def action_spec(self):
        shape = (-1,) if self.max_num_players > 1 else ()
        return {"action": ArraySpec(np.int32, shape, 0, 1, is_discrete=True)}

    def plan_reset(self, d):
        d.perm("deal", 3)

    def _obs(self, st):
        return {"obs:card": take(st["cards"], st["player"]), "obs:history": st["history"],
                "obs:current_player": st["player"]}

    def reset_env(self, draws):
        b = draws["rows"].shape[0]
        st = {"cards": draws["deal"][:, :2].to(torch.int32),
              "history": torch.zeros((b, 3), dtype=torch.int32, device=self.device),
              "player": torch.zeros(b, dtype=torch.int32, device=self.device)}
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        p = state["player"]
        bet = mover_action(action, p, self.max_num_players) == 1
        hist, cards = state["history"], state["cards"]
        turn = hist[:, 2]
        p0_bet = hist[:, 0] == 1
        showdown_winner = torch.where(cards[:, 0] > cards[:, 1], 0, 1)
        t0, t1, t2 = turn == 0, turn == 1, turn >= 2
        t1_pp = t1 & ~p0_bet & ~bet        # check-check
        t1_fold = t1 & p0_bet & ~bet       # p1 folds
        t1_call = t1 & p0_bet & bet        # call
        t2_fold = t2 & ~bet                # p0 folds
        t2_call = t2 & bet                 # p0 calls
        terminated = t1_pp | t1_fold | t1_call | t2_fold | t2_call
        pot = torch.where(t1_call | t2_call, 2, 1)
        winner = torch.where(t1_fold, 0, torch.where(t2_fold, 1, showdown_winner))
        b32 = bet.to(torch.int32)
        history = torch.stack([torch.where(t0, b32, hist[:, 0]),
                               torch.where(t1, b32, hist[:, 1]), turn + 1], 1)
        next_player = torch.where(terminated, p, 1 - p).to(torch.int32)
        st = {"cards": cards, "history": history, "player": next_player}
        win = pot.to(torch.float32)
        if self.max_num_players > 1:
            out = torch.zeros((p.shape[0], self.max_num_players), dtype=torch.float32,
                              device=p.device)
            out[rows(p), winner] = win
            out[rows(p), 1 - winner] = -win
            reward = torch.where(terminated[:, None], out, 0.0)
        else:
            reward = torch.where(terminated, torch.where(winner == p, win, -win), 0.0).to(
                torch.float32)
        return EnvOut(state=st, obs=self._obs(st), reward=reward, terminated=terminated)
