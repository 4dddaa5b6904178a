"""Per-env counter-based random streams on device.

The JAX engine keeps one threefry key per env and splits it every step
(``envpool_tpu/core/engine.py:165-180``).  Torch's Philox cannot reproduce
those bits, so the port keeps its own per-env streams: a key is an
``[N, 2]`` int64 tensor of two 32-bit words, ``(stream, counter)``, seeded
from ``seed + env_id`` (or ``env_seed``).  :func:`split` hands out a
subkey and advances the counter; :func:`randint`, :func:`uniform` and
:func:`normal` hash ``(subkey, slot)`` into draws per env.
An env's draws therefore depend only on its own seed and step count, never
on ``num_envs``.

All arithmetic stays below 2**63 in int64, so the hash gives the same
bits on the CPU and on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.batched import const, first_true

__all__ = [
    "seed_keys",
    "split",
    "randint",
    "uniform",
    "uniform_range",
    "normal",
    "random_bits",
    "Draws",
]

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
# Draws.accept: candidates a round, the slots between two rounds' first
# slots, and the rounds before it gives up.
ACCEPT_K = 16
_ROUND_SLOTS = 1 << 20
_MAX_ROUNDS = 64


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for 32-bit ``x`` without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (the "lowbias32" hash)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def seed_keys(seeds: np.ndarray, device: torch.device) -> torch.Tensor:
    """``[N, 2]`` keys ``(seed mod 2**32, 0)`` from per-env integer seeds."""
    stream = torch.as_tensor(
        np.asarray(seeds, np.int64) & _M32, dtype=torch.int64, device=device
    )
    return torch.stack([stream, torch.zeros_like(stream)], dim=1)


def split(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(next_key, subkey)``: the subkey feeds this step's draws."""
    stream, counter = key[:, 0], key[:, 1]
    sub = torch.stack(
        [_mix32(stream ^ _mix32(counter)), _mix32(counter ^ _GOLDEN)], dim=1
    )
    nxt = torch.stack([stream, (counter + 1) & _M32], dim=1)
    return nxt, sub


def random_bits(sub: torch.Tensor, slot: int, k: int | None = None) -> torch.Tensor:
    """``[N]`` uniform 32-bit words (int64) for draw number ``slot``; with
    ``k``, ``[N, k]`` words for draws ``slot .. slot + k - 1``."""
    stream, counter = sub[:, 0], sub[:, 1]
    if k is not None:
        stream, counter = stream[:, None], counter[:, None]
        slot = torch.arange(slot, slot + k, device=sub.device)
    salt = _mix32(counter ^ ((slot * _GOLDEN) & _M32))
    return _mix32(stream ^ salt)


def randint(sub: torch.Tensor, slot: int, n: int, k: int | None = None) -> torch.Tensor:
    """``[N]`` int32 draws uniform in ``[0, n)``; ``[N, k]`` with ``k``."""
    return ((random_bits(sub, slot, k) * n) >> 32).to(torch.int32)


def uniform(sub: torch.Tensor, slot: int, k: int | None = None) -> torch.Tensor:
    """``[N]`` float32 draws uniform in ``[0, 1)``; ``[N, k]`` with ``k``."""
    return (random_bits(sub, slot, k) >> 8).to(torch.float32) * (2.0**-24)


def uniform_range(
    sub: torch.Tensor, lo: float, hi: float, k: int, slot: int = 0
) -> torch.Tensor:
    """``[N, k]`` float32 draws uniform in ``[lo, hi)``."""
    return lo + (hi - lo) * uniform(sub, slot, k)


def normal(sub: torch.Tensor, slot: int, k: int) -> torch.Tensor:
    """``[N, k]`` float32 standard normal draws: Box-Muller over the
    uniform draws of slots ``slot .. slot + 2k - 1``."""
    u = uniform(sub, slot, 2 * k)
    radius = torch.sqrt(-2.0 * torch.log(1.0 - u[:, :k]))  # 1 - u is in (0, 1]
    return radius * torch.cos(2.0 * math.pi * u[:, k:])


class Draws:
    """The draws of one reset or step for every row, made in the order the
    JAX env makes them: each call takes fresh slots of the stream of
    subkeys ``sub`` and stores its value under ``name`` in :attr:`out`.
    ``out["rows"]`` (``[N, 0]``) carries the row count.  An env declares
    its draws in a ``plan_reset(d)`` / ``plan_step(d)`` of its own, so that
    a test can hand it recorded JAX values by position instead."""

    def __init__(self, sub: torch.Tensor):
        self.sub = sub
        self.slot = 0
        self.out = {"rows": torch.zeros((sub.shape[0], 0), dtype=torch.int8, device=sub.device)}

    def _bits(self, k: int | None) -> torch.Tensor:
        slot = self.slot
        self.slot += k or 1
        return random_bits(self.sub, slot, k)

    def _put(self, name: str, value: torch.Tensor) -> torch.Tensor:
        self.out[name] = value
        return value

    def randint(self, name: str, lo, hi, shape: tuple = (), share: str | None = None):
        """int32 uniform in ``[lo, hi)`` (``lo``, ``hi`` ints or ``[N]``
        tensors), ``[N, *shape]``; with ``share``, the value of that earlier
        draw (the JAX env drew both from one key)."""
        if share is not None:
            return self._put(name, self.out[share])
        k = int(np.prod(shape)) if shape else None
        bits = self._bits(k)
        lo = torch.as_tensor(lo, device=bits.device).to(torch.int64)
        span = (torch.as_tensor(hi, device=bits.device).to(torch.int64) - lo).clamp(min=0)
        if shape:
            lo, span = lo.reshape(-1, 1), span.reshape(-1, 1)
        v = lo + ((bits * span) >> 32)
        return self._put(name, v.reshape(-1, *shape).to(torch.int32))

    def cells(self, name: str, k: int) -> torch.Tensor:
        """``[N, k]`` float32 noise of one categorical pick over ``k``
        choices (:func:`pick`)."""
        slot = self.slot
        self.slot += k
        return self._put(name, uniform(self.sub, slot, k))

    def perm(self, name: str, n: int) -> torch.Tensor:
        """``[N, n]`` int32: a uniform permutation of ``range(n)``."""
        order = torch.argsort(self._bits(n), dim=1, stable=True)
        return self._put(name, order.to(torch.int32))

    def bernoulli(self, name: str) -> torch.Tensor:
        """``[N]`` bool, true with probability 1/2."""
        return self._put(name, (self._bits(None) >> 31) == 1)

    def choice(self, name: str, options: tuple) -> torch.Tensor:
        """``[N]`` int8: one of ``options``, uniformly."""
        idx = ((self._bits(None) * len(options)) >> 32).long()
        return self._put(name, const(options, self.sub.device, torch.int8)[idx])

    def uniform(self, name: str, shape: tuple = (), lo=0.0, hi=1.0) -> torch.Tensor:
        """float32 uniform in ``[lo, hi)``, ``[N, *shape]``: ``u * (hi - lo)
        + lo`` in float32, at least ``lo`` (``jax.random.uniform``'s
        formula).  ``lo`` and ``hi`` are floats or, per component of the
        last axis, sequences of ``shape[-1]`` floats."""
        k = int(np.prod(shape)) if shape else None
        slot = self.slot
        self.slot += k or 1
        u = uniform(self.sub, slot, k).reshape(-1, *shape)
        lo32, hi32 = np.float32(lo), np.float32(hi)
        if lo32.ndim:
            dev = self.sub.device
            span = const(tuple(float(x) for x in hi32 - lo32), dev)
            low = const(tuple(float(x) for x in lo32), dev)
            u = torch.maximum(u * span + low, low)
        elif (lo, hi) != (0.0, 1.0):
            u = torch.clamp_min(u * float(hi32 - lo32) + float(lo32), float(lo32))
        return self._put(name, u)

    def normal(self, name: str, shape: tuple = ()) -> torch.Tensor:
        """float32 standard normal, ``[N, *shape]`` (:func:`normal`'s
        Box-Muller, two uniform slots per value)."""
        k = int(np.prod(shape)) if shape else 1
        slot = self.slot
        self.slot += 2 * k
        return self._put(name, normal(self.sub, slot, k).reshape(-1, *shape))

    def accept(self, name: str, draw, ok, k: int = ACCEPT_K) -> torch.Tensor:
        """A rejection sampler in one round for nearly every row: ``draw(d,
        k)`` makes ``[N, k, ...]`` candidates from a :class:`Draws` ``d``,
        ``ok(c)`` says ``[N, k]`` which satisfy the predicate, and each row
        takes its first good candidate.  The rows with none (for ``k``
        candidates each accepted with probability ``p``, a share of ``(1 -
        p) ** k``) draw ``k`` more from slots far past the plan's, until
        every row has one: one host sync per call.  A row's value depends on
        its own stream alone, and the draws after this one take the slots
        after the first round's."""
        base = self.slot
        value, found = None, None
        for r in range(_MAX_ROUNDS):
            sub = Draws(self.sub)
            sub.slot = base + r * _ROUND_SLOTS
            cand = draw(sub, k)
            if r == 0:
                self.slot = sub.slot
            good = ok(cand)
            first = first_true(good)
            pick = cand.gather(1, first.reshape(-1, 1, *([1] * (cand.ndim - 2))).expand(
                -1, 1, *cand.shape[2:]))[:, 0]
            hit = good.any(1)
            if value is None:
                value, found = pick, hit
            else:
                grow = hit & ~found
                value = torch.where(grow.reshape(-1, *([1] * (value.ndim - 1))), pick, value)
                found = found | grow
            if bool(found.all()):
                return self._put(name, value)
        raise RuntimeError(f"{name}: no candidate accepted in {_MAX_ROUNDS * k} draws")
