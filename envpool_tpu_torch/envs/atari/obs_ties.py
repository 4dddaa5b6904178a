"""Which obs pixels of an arcade pool sit on an exact ``k + 0.5`` tie.

Two correct resizes of the same frame may round a tie pixel to different
sides (see ``ops/image.py``), and the frame stack carries such a pixel
for ``stack_num`` steps.  :class:`ObsTies` follows an :class:`ArcadeEnv`
as an engine drives it: it records the raw frame pairs that the env hands
to K1 and keeps a stack of tie masks shaped like the obs, so a comparison
of two pools' obs can allow a difference of 1 at those pixels and nowhere
else.  It assumes full restarts on reset (``episodic_life=False``).
"""

from __future__ import annotations

import torch

from ...ops.image import area_ties
from .arcade_env import ArcadeEnv

__all__ = ["ObsTies"]


class ObsTies:
    """Tie masks for the obs of every step of one pool's env."""

    def __init__(self, env: ArcadeEnv):
        if bool(env.config["episodic_life"]):
            raise ValueError("ObsTies assumes episodic_life=False")
        self._env = env
        self._pairs: list = []
        self._stack: torch.Tensor | None = None
        inner = env._shrink

        def shrink(f0, f1):
            self._pairs.append((f0, f1))
            return inner(f0, f1)

        env._shrink = shrink

    def _ties(self, pair) -> torch.Tensor:
        env = self._env
        t = area_ties(pair[0], pair[1], env._img_hw)
        return t if t.ndim == 4 else t[:, None]  # [N, C, h, w]

    def assume_equal(self, n: int) -> None:
        """Start from ``n`` rows whose stacks are identical on both sides
        (e.g. one state injected into both pools): no tie pixels yet."""
        env = self._env
        h, w = env._img_hw
        self._stack = torch.zeros(
            (n, env._stack_num, env._channels, h, w), dtype=torch.bool
        )

    def after_reset(self) -> torch.Tensor:
        """Masks for the obs of a full-batch reset."""
        (pair,) = self._pairs
        self._pairs.clear()
        new = self._ties(pair)
        self._stack = new[:, None].expand(-1, self._env._stack_num, -1, -1, -1)
        return self._obs()

    def after_step(self, do_reset: torch.Tensor) -> torch.Tensor:
        """Masks for the obs of an engine step; ``do_reset`` is ``[N]`` bool."""
        reset_pair, step_pair = self._pairs
        self._pairs.clear()
        r = do_reset.to(self._stack.device)[:, None, None, None]
        new = torch.where(r, self._ties(reset_pair), self._ties(step_pair))
        pushed = torch.cat([self._stack[:, 1:], new[:, None]], dim=1)
        filled = new[:, None].expand_as(self._stack)
        self._stack = torch.where(r[:, None], filled, pushed)
        return self._obs()

    def _obs(self) -> torch.Tensor:
        n, s, c, h, w = self._stack.shape
        return self._stack.reshape(n, s * c, h, w)
