"""Blackjack, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/toy_text/blackjack.py`` (reference
``envpool/toy_text/blackjack.h:34-160``).  Cards are ``min(10, U[1, 13])``
with replacement.  State tracks raw hand sums, ace presence, hand sizes and
the two first cards of each hand (enough for the natural check), as the
JAX env does.  The reference's obs quirk is kept: ``obs[2]`` is *ace
present*, not gym's "usable ace".

A stick plays the dealer out: the dealer draws while its hand is below 17,
at most 16 cards (a raw sum gains at least 1 per card, from at least 2).
Every step draws all 16 for every row, and the dealer's loop is 16 selects
over the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec

_DEALER_CARDS = 16


def _card(rank: torch.Tensor) -> torch.Tensor:
    """A card's value from its rank in ``[1, 13]``."""
    return torch.clamp_max(rank, 10).to(torch.int32)


def _sum_hand(raw_sum, has_ace):
    """Raw sum, counting the usable ace as +10 when it fits."""
    return torch.where(has_ace & (raw_sum + 10 <= 21), raw_sum + 10, raw_sum)


def _score(raw_sum, has_ace):
    s = _sum_hand(raw_sum, has_ace)
    return torch.where(s > 21, 0, s)


def _is_natural(first):
    a, b = first.unbind(1)
    return ((a == 1) & (b == 10)) | ((a == 10) & (b == 1))


class BlackjackEnv(TorchEnv):
    DEFAULT_CONFIG = {"natural": False, "sab": True}

    def state_spec(self):
        return {"obs": ArraySpec(np.int32, (3,), 0, 31)}

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 1, is_discrete=True)}

    def reset_draws(self, sub):
        """``ranks`` ``[N, 4]`` int32 uniform in ``[1, 13]``: the player's
        two cards, then the dealer's."""
        return {"ranks": rng.randint(sub, 0, 13, 4) + 1}

    def step_draws(self, sub):
        """``hit`` ``[N]`` and ``dealer`` ``[N, 16]`` int32 ranks uniform in
        ``[1, 13]``: the card a hit takes, and the cards a stick deals the
        dealer, in order."""
        return {"hit": rng.randint(sub, 0, 13) + 1,
                "dealer": rng.randint(sub, 1, 13, _DEALER_CARDS) + 1}

    @staticmethod
    def _obs(p_sum, p_ace, d0):
        return {"obs": torch.stack([_sum_hand(p_sum, p_ace), d0, p_ace.to(torch.int32)], 1)
                .to(torch.int32)}

    def reset_env(self, draws):
        cards = _card(draws["ranks"])
        p0, p1, d0, d1 = cards.unbind(1)
        state = {
            "p_sum": p0 + p1,
            "p_ace": (p0 == 1) | (p1 == 1),
            "p_cards": torch.full_like(p0, 2),
            "p_first": cards[:, :2],
            "d_sum": d0 + d1,
            "d_ace": (d0 == 1) | (d1 == 1),
            "d_first": cards[:, 2:],
        }
        return state, self._obs(state["p_sum"], state["p_ace"], d0)

    def step_env(self, state, action, draws):
        # Hit: one card for the player.
        card = _card(draws["hit"])
        hit_sum = state["p_sum"] + card
        hit_ace = state["p_ace"] | (card == 1)
        hit_bust = _sum_hand(hit_sum, hit_ace) > 21
        # Stick: the dealer plays out.
        d_sum, d_ace = state["d_sum"], state["d_ace"]
        dealt = _card(draws["dealer"])
        for i in range(_DEALER_CARDS):
            more = _sum_hand(d_sum, d_ace) < 17
            c = dealt[:, i]
            d_sum = torch.where(more, d_sum + c, d_sum)
            d_ace = torch.where(more, d_ace | (c == 1), d_ace)
        p_score = _score(state["p_sum"], state["p_ace"])
        d_score = _score(d_sum, d_ace)
        stick_reward = (p_score > d_score).to(torch.float32) - (p_score < d_score).to(torch.float32)
        p_nat = (state["p_cards"] == 2) & _is_natural(state["p_first"])
        d_nat = _is_natural(state["d_first"])
        if bool(self.config["sab"]):
            stick_reward = torch.where(p_nat & ~d_nat, 1.0, stick_reward)
        elif bool(self.config["natural"]):
            stick_reward = torch.where(p_nat & (stick_reward == 1.0), 1.5, stick_reward)

        hit = action != 0
        new_state = {
            "p_sum": torch.where(hit, hit_sum, state["p_sum"]),
            "p_ace": torch.where(hit, hit_ace, state["p_ace"]),
            "p_cards": torch.where(hit, state["p_cards"] + 1, state["p_cards"]),
            "p_first": state["p_first"],
            "d_sum": torch.where(hit, state["d_sum"], d_sum),
            "d_ace": torch.where(hit, state["d_ace"], d_ace),
            "d_first": state["d_first"],
        }
        reward = torch.where(hit, torch.where(hit_bust, -1.0, 0.0), stick_reward)
        return EnvOut(
            state=new_state,
            obs=self._obs(new_state["p_sum"], new_state["p_ace"], state["d_first"][:, 0]),
            reward=reward.to(torch.float32),
            terminated=torch.where(hit, hit_bust, True),
        )
