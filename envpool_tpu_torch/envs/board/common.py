"""Helpers shared by the board games, batched over ``[N]`` envs.

The JAX games are written for one env and ``vmap``ped; here every value
carries a leading env axis.  A scalar of the JAX state is an ``[N]``
tensor of the same dtype, a JAX board ``[n, n]`` is ``[N, n, n]``.
"""

from __future__ import annotations

import torch

from ...core.env import TorchEnv
from ...core.rng import Draws

__all__ = ["BoardEnv", "rows", "first_row_action", "mover_action", "per_player_reward", "seat_rewards", "shift2d",
           "take", "u32_table", "uint32_hash"]


def rows(x: torch.Tensor) -> torch.Tensor:
    """``[N]`` row indices of a batched tensor."""
    return torch.arange(x.shape[0], device=x.device)


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i, idx[i], ...]`` of each row (``idx`` ``[N]``)."""
    return x[rows(x), idx.long()]


def mover_action(action: torch.Tensor, player: torch.Tensor, players: int) -> torch.Tensor:
    """The action of the player to move: the env's own row of the EnvPool
    per-player protocol (``[N, P]`` actions) with ``players > 1``."""
    if players > 1:
        return take(action, player)
    return action


def first_row_action(action: torch.Tensor, players: int) -> torch.Tensor:
    """The action of the games that read row 0 of the player rows
    (``jnp.reshape(action, (-1,))[0]``)."""
    if players > 1:
        return action.reshape(action.shape[0], -1)[:, 0]
    return action.reshape(-1)


def per_player_reward(mover_reward: torch.Tensor, player: torch.Tensor,
                      terminated: torch.Tensor, players: int) -> torch.Tensor:
    """The JAX package's ``_per_player_reward``: the mover's reward alone,
    or ``[N, P]`` rows where the other seat gets the negated reward of a
    terminal step (zero-sum)."""
    if players <= 1:
        return mover_reward
    out = torch.zeros(player.shape[0], players, dtype=torch.float32, device=player.device)
    r = rows(player)
    out[r, player.long()] = mover_reward
    out[r, (1 - player).long()] = torch.where(terminated, -mover_reward, 0.0)
    return out


def seat_rewards(loser: torch.Tensor, winner_value: float, loser_value: float) -> torch.Tensor:
    """``[N, 2]``: ``winner_value`` for both seats, then ``loser_value`` at
    the seat ``loser`` (``jnp.full(2, w).at[l].set(v)``)."""
    out = torch.full((loser.shape[0], 2), winner_value, dtype=torch.float32,
                     device=loser.device)
    out[rows(loser), loser.long()] = loser_value
    return out


def shift2d(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """``y[..., r, c] = x[..., r + dr, c + dc]`` with off-board cells
    ``fill`` (the JAX games' ``_nbr``)."""
    h, w = x.shape[-2:]
    y = torch.full_like(x, fill)
    rs, rd = (slice(dr, h), slice(0, h - dr)) if dr >= 0 else (slice(0, h + dr), slice(-dr, h))
    cs, cd = (slice(dc, w), slice(0, w - dc)) if dc >= 0 else (slice(0, w + dc), slice(-dc, w))
    y[..., rd, cd] = x[..., rs, cs]
    return y


def uint32_hash(words: torch.Tensor) -> torch.Tensor:
    """XOR over the last axis of int32 words: the bits of JAX's XOR of
    uint32 Zobrist words (XOR and equality are the same on either view),
    halving the axis each pass."""
    while words.shape[-1] > 1:
        k = words.shape[-1]
        half = words[..., : k // 2] ^ words[..., k // 2: 2 * (k // 2)]
        words = torch.cat([half, words[..., 2 * (k // 2):]], -1) if k % 2 else half
    return words[..., 0]


def u32_table(table) -> torch.Tensor:
    """A numpy uint32 table as int32 words of the same bits (CPU)."""
    import numpy as np

    return torch.from_numpy(np.ascontiguousarray(table).view(np.int32).copy())


class BoardEnv(TorchEnv):
    """A board game whose draws are declared in the JAX game's order:
    ``plan_reset(d)`` and ``plan_step(d)`` call :class:`Draws` (none by
    default); ``draws["rows"]`` carries the row count."""

    DEFAULT_CONFIG: dict = {}

    def plan_reset(self, d) -> None:
        del d

    def plan_step(self, d) -> None:
        del d

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    def step_draws(self, sub):
        d = Draws(sub)
        self.plan_step(d)
        return d.out


def min_labels(links: list, big: int, check_every: int = 4) -> torch.Tensor:
    """``[N, H, W]`` int32: each cell's least flat index over the cells it
    is joined to, the fixpoint of the JAX games' min-label
    ``lax.while_loop``.  ``links`` holds ``(dr, dc, join)``: ``join[n, r,
    c]`` says that cell ``(r, c)`` is joined to ``(r + dr, c + dc)`` (both
    directions of a pair must be listed).  Each pass takes the min over the
    joined neighbours, then jumps every label to its label's label (a
    label is always a cell of the same component, whose own label is no
    larger), which cuts the passes from a chain's length to about its log.
    Convergence is tested every ``check_every`` passes (one host sync
    each): a pass that changes nothing is the fixpoint.
    ``min_labels.passes`` counts the passes run, over every call."""
    join = links[0][2]
    n, h, w = join.shape
    labels = torch.arange(h * w, dtype=torch.int32, device=join.device).reshape(1, h, w)
    labels = labels.expand(n, h, w).contiguous()
    while True:
        before = labels
        for _ in range(check_every):
            new = labels
            for dr, dc, j in links:
                new = torch.where(j, torch.minimum(new, shift2d(labels, dr, dc, big)), new)
            flat = new.reshape(n, -1)
            labels = flat.gather(1, flat.long()).reshape(n, h, w)
        min_labels.passes += check_every
        if torch.equal(labels, before):
            return labels


min_labels.passes = 0
