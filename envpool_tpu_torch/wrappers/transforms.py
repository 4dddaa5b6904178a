"""Composable wrappers over the batched env contract.

Counterpart of ``envpool_tpu/wrappers/transforms.py``.  The reference
fuses its wrapper logic (frame stack, reward clip) into each C++ env
(``envpool/atari/atari_env.h:202-346``); here a wrapper is a ``TorchEnv``
around another, whose ``reset_env`` / ``step_env`` transform the inner
env's over the same ``[N, ...]`` batch, so wrappers compose and run on
the pool's device.  What a wrapper carries across steps (a frame stack,
running statistics) lives in the env state, beside the inner env's.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..core.env import EnvOut, TorchEnv
from ..core.specs import ArraySpec

__all__ = [
    "FrameStack",
    "NormalizeObs",
    "RewardClip",
    "TransformObservation",
    "TransformReward",
    "Wrapper",
]


class Wrapper(TorchEnv):
    """Base wrapper: delegates everything to ``inner``."""

    def __init__(self, inner: TorchEnv):
        self.inner = inner
        super().__init__(inner.config)

    @property
    def reward_threshold(self):
        return self.inner.reward_threshold

    def state_spec(self):
        return self.inner.state_spec()

    def action_spec(self):
        return self.inner.action_spec()

    def reset_draws(self, sub):
        return self.inner.reset_draws(sub)

    def step_draws(self, sub):
        return self.inner.step_draws(sub)

    def reset_env(self, draws):
        return self.inner.reset_env(draws)

    def step_env(self, state, action, draws):
        return self.inner.step_env(state, action, draws)


def _per_env(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``[N]`` values shaped to broadcast against ``like`` ``[N, ...]``."""
    return x.reshape(x.shape + (1,) * (like.dim() - 1))


class FrameStack(Wrapper):
    """Stack the last ``stack_num`` observations along a new axis after
    the batch.

    Reference behavior (``atari_env.h:308-346``): at reset the single fresh
    frame fills all slots (``push_all``); at step the newest frame is
    pushed and the oldest dropped.
    """

    def __init__(self, inner: TorchEnv, stack_num: int, obs_key: str = "obs"):
        super().__init__(inner)
        self.stack_num = stack_num
        self.obs_key = obs_key

    def state_spec(self):
        spec = dict(self.inner.state_spec())
        base = spec[self.obs_key]
        spec[self.obs_key] = ArraySpec(
            base.dtype, (self.stack_num, *base.shape), base.minimum, base.maximum,
            base.is_discrete,
        )
        return spec

    def reset_env(self, draws):
        state, obs = self.inner.reset_env(draws)
        frame = obs[self.obs_key]
        stack = frame[:, None].expand(-1, self.stack_num, *frame.shape[1:]).contiguous()
        return {"inner": state, "stack": stack}, {**obs, self.obs_key: stack}

    def step_env(self, state, action, draws):
        out = self.inner.step_env(state["inner"], action, draws)
        stack = torch.cat([state["stack"][:, 1:], out.obs[self.obs_key][:, None]], 1)
        return EnvOut(
            state={"inner": out.state, "stack": stack},
            obs={**out.obs, self.obs_key: stack},
            reward=out.reward,
            terminated=out.terminated,
            discount=out.discount,
            truncated=out.truncated,
        )


class TransformReward(Wrapper):
    """Apply ``fn`` to the reward."""

    def __init__(self, inner: TorchEnv, fn: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__(inner)
        self._fn = fn

    def step_env(self, state, action, draws):
        out = self.inner.step_env(state, action, draws)
        out.reward = self._fn(out.reward).to(torch.float32)
        return out


class RewardClip(TransformReward):
    """Sign-clip rewards to {-1, 0, 1} (``atari_env.h:259-266``).

    The unclipped reward is exposed as ``info:reward``, matching the
    reference's ``info:reward`` state key (``atari_env.h:70``).
    """

    def __init__(self, inner: TorchEnv):
        super().__init__(inner, torch.sign)

    def state_spec(self):
        spec = dict(self.inner.state_spec())
        spec.setdefault("info:reward", ArraySpec(np.float32, ()))
        return spec

    def reset_env(self, draws):
        state, obs = self.inner.reset_env(draws)
        obs = dict(obs)
        n = next(iter(obs.values())).shape[0]
        obs.setdefault("info:reward", torch.zeros(n, dtype=torch.float32, device=self.device))
        return state, obs

    def step_env(self, state, action, draws):
        out = self.inner.step_env(state, action, draws)
        info_reward = out.reward
        out.reward = torch.sign(out.reward).to(torch.float32)
        out.obs = dict(out.obs)
        out.obs.setdefault("info:reward", info_reward)
        return out


class NormalizeObs(Wrapper):
    """Running observation normalization (Welford, carried in env state).

    Statistics are tracked **per env** (each env's stream normalizes
    itself), under ``stats`` ``{"count" [N], "mean", "m2"}`` in the
    state, kept across episodes.  ``epsilon`` and clipping follow gym's
    NormalizeObservation.
    """

    def __init__(self, inner: TorchEnv, obs_key: str = "obs", epsilon: float = 1e-8,
                 clip: float = 10.0):
        super().__init__(inner)
        self.obs_key = obs_key
        self.epsilon = epsilon
        self.clip = clip

    def _norm(self, stats, obs):
        count = stats["count"] + 1.0
        delta = obs - stats["mean"]
        mean = stats["mean"] + delta / _per_env(count, obs)
        m2 = stats["m2"] + delta * (obs - mean)
        var = m2 / _per_env(torch.clamp_min(count - 1.0, 1.0), obs)
        normed = torch.clamp((obs - mean) / torch.sqrt(var + self.epsilon),
                             -self.clip, self.clip)
        return {"count": count, "mean": mean, "m2": m2}, normed

    def _wrap(self, inner_state, obs, stats):
        stats, normed = self._norm(stats, obs[self.obs_key])
        return {"inner": inner_state, "stats": stats}, {**obs, self.obs_key: normed}

    def reset_env(self, draws):
        state, obs = self.inner.reset_env(draws)
        raw = obs[self.obs_key]
        zero = {"count": raw.new_zeros(raw.shape[0]), "mean": torch.zeros_like(raw),
                "m2": torch.zeros_like(raw)}
        return self._wrap(state, obs, zero)

    def reset_env_from(self, state, draws, full):
        inner_state, obs = self.inner.reset_env_from(state["inner"], draws, full)
        # Keep running stats across episodes (gym semantics).
        return self._wrap(inner_state, obs, state["stats"])

    def step_env(self, state, action, draws):
        out = self.inner.step_env(state["inner"], action, draws)
        new_state, obs = self._wrap(out.state, out.obs, state["stats"])
        return EnvOut(
            state=new_state,
            obs=obs,
            reward=out.reward,
            terminated=out.terminated,
            discount=out.discount,
            truncated=out.truncated,
        )


class TransformObservation(Wrapper):
    """Apply ``fn`` to one obs key (give ``new_spec`` if its shape changes)."""

    def __init__(self, inner: TorchEnv, fn: Callable[[torch.Tensor], torch.Tensor],
                 obs_key: str = "obs", new_spec: ArraySpec | None = None):
        super().__init__(inner)
        self._fn = fn
        self.obs_key = obs_key
        self._new_spec = new_spec

    def state_spec(self):
        spec = dict(self.inner.state_spec())
        if self._new_spec is not None:
            spec[self.obs_key] = self._new_spec
        return spec

    def _apply(self, obs: dict[str, Any]) -> dict[str, Any]:
        return {**obs, self.obs_key: self._fn(obs[self.obs_key])}

    def reset_env(self, draws):
        state, obs = self.inner.reset_env(draws)
        return state, self._apply(obs)

    def step_env(self, state, action, draws):
        out = self.inner.step_env(state, action, draws)
        out.obs = self._apply(out.obs)
        return out
