"""NChain, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/toy_text/nchain.py`` (reference
``envpool/toy_text/nchain.h:34-108``).  A chain of 5 states; with
probability 0.2 the action flips; action 1 ("return") gives +2 and jumps to
state 0; action 0 advances (reward 0) until state 4, which yields +10.
State is ``[N]`` int32; the episode ends only at the time limit.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec


class NChainEnv(TorchEnv):
    DEFAULT_CONFIG = {}

    def state_spec(self):
        return {"obs": ArraySpec(np.int32, (), 0, 4, is_discrete=True)}

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 1, is_discrete=True)}

    def step_draws(self, sub):
        """``u`` ``[N]`` float32 uniform in ``[0, 1)``: the action flips
        where it is below 0.2."""
        return {"u": rng.uniform(sub, 0)}

    def reset_env(self, draws):
        del draws
        s = torch.zeros(self.num_envs, dtype=torch.int32, device=self.device)
        return s, {"obs": s}

    def step_env(self, state, action, draws):
        act = torch.where(draws["u"] < 0.2, 1 - action, action)
        back = act != 0
        at_end = state >= 4
        reward = torch.where(back, 2.0, torch.where(at_end, 10.0, 0.0)).to(torch.float32)
        new_s = torch.where(back, 0, torch.where(at_end, state, state + 1)).to(torch.int32)
        return EnvOut(
            state=new_s,
            obs={"obs": new_s},
            reward=reward,
            terminated=torch.zeros_like(back),
        )
