"""Procgen env family (16 games x distribution modes = 50 ids), batched in
PyTorch.

Counterpart of ``envpool_tpu/envs/procgen`` (reference surface:
``envpool/procgen/procgen_env.h``): three engines, grid (maze, heist,
chaser, miner), scroller (bigfish, starpilot, fruitbot, dodgeball,
bossfight, caveflyer, plunder) and platformer (coinrun, ninja, jumper,
climber, leaper), with schematic pixel art.
"""

from .env import ProcgenEnv

__all__ = ["ProcgenEnv"]
