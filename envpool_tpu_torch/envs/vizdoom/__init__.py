"""ViZDoom env family (20 scenarios + the custom slot), batched in PyTorch.

Counterpart of ``envpool_tpu/envs/vizdoom`` (reference surface:
``envpool/vizdoom/vizdoom_env.h``): stacked CHW frames from a raycaster
over per-scenario grid maps, the combined button action space, the
game-variable info keys and the reward shaping from variable deltas.
"""

from .doom_env import DoomEnv

__all__ = ["DoomEnv"]
