"""``from_pixels`` for the physics envs, batched.

Counterpart of ``envpool_tpu/envs/pixels.py`` (reference
``registration.py:142-185``, ``mujoco/frame_stack.h:182-303``):
``make(task, env_type, from_pixels=True, ...)`` wraps a physics env (one
with a ``model`` that has a geom table and a ``qpos`` state entry) so that
its observation is the last ``stack`` frames ``[N, stack, H, W]`` uint8
rendered by ``ops.rasterize.render_scene`` from the new state; the
``info:*`` fields pass through.  At a reset every slot holds the first
frame.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.env import EnvOut, TorchEnv
from ..core.specs import ArraySpec
from ..ops.rasterize import render_scene

__all__ = ["PixelWrapper", "wrap_from_pixels"]


class PixelWrapper(TorchEnv):
    """A physics env whose observation is rendered pixel frames."""

    def __init__(self, inner: TorchEnv, height: int = 84, width: int = 84,
                 stack: int = 3, track_body: int = 1, view_size: float = 2.0):
        super().__init__(inner.config)
        self.inner = inner
        self.height = height
        self.width = width
        self.stack = stack
        self.track_body = min(track_body, len(inner.model.body_names) - 1)
        self.view_size = view_size

    # -- specs -------------------------------------------------------------

    def state_spec(self):
        spec = {"obs": ArraySpec(np.uint8, (self.stack, self.height, self.width), 0, 255)}
        for k, v in self.inner.state_spec().items():
            if k.startswith("info:"):
                spec[k] = v
        return spec

    def action_spec(self):
        return self.inner.action_spec()

    def reset_draws(self, sub):
        return self.inner.reset_draws(sub)

    def step_draws(self, sub):
        return self.inner.step_draws(sub)

    # -- render ------------------------------------------------------------

    def frame(self, qpos: torch.Tensor) -> torch.Tensor:
        """``[N, H, W]`` uint8 frames of the states ``qpos``."""
        img = render_scene(self.inner.model, qpos, self.height, self.width,
                           self.track_body, self.view_size)
        return torch.clamp(img, 0, 255).to(torch.uint8)

    def _obs(self, inner_obs, frames):
        out = {"obs": frames}
        for k, v in inner_obs.items():
            if k.startswith("info:"):
                out[k] = v
        return out

    def _first(self, st, obs):
        frames = self.frame(st["qpos"])[:, None].expand(-1, self.stack, -1, -1).contiguous()
        return {"inner": st, "frames": frames}, self._obs(obs, frames)

    # -- TorchEnv contract -------------------------------------------------

    def reset_env(self, draws):
        return self._first(*self.inner.reset_env(draws))

    def reset_env_from(self, state, draws, full):
        return self._first(*self.inner.reset_env_from(state["inner"], draws, full))

    def step_env(self, state, action, draws):
        out = self.inner.step_env(state["inner"], action, draws)
        frame = self.frame(out.state["qpos"])
        frames = torch.cat([state["frames"][:, 1:], frame[:, None]], 1)
        return EnvOut(
            state={"inner": out.state, "frames": frames},
            obs=self._obs(out.obs, frames),
            reward=out.reward,
            terminated=out.terminated,
            discount=out.discount,
            truncated=out.truncated,
        )


def wrap_from_pixels(env: TorchEnv, **kwargs: Any) -> TorchEnv:
    if not hasattr(env, "model") or env.model.geom_body is None:
        raise ValueError(
            "from_pixels requires a physics-backed env with a geom table "
            f"({type(env).__name__} has none)"
        )
    return PixelWrapper(env, **kwargs)
