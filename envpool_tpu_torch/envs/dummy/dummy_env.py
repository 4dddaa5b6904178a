"""Dummy env, batched over ``[N]`` envs: the machinery-exercising fixture.

Counterpart of ``envpool_tpu/envs/dummy/dummy_env.py`` (reference
``envpool/dummy/dummy_envpool.h:25-104``).  It exercises env-specific
config, several obs and info keys, a per-player field under
``max_num_players`` (``obs:dyn``, ``[N, 2]`` for one player, else
``[N, players, 2]``), deterministic state and the action echo the
reference's tests assert on.  State is ``counter`` and ``last_action``,
``[N]`` int32 each; an episode ends after ``state_num`` steps.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec


class DummyEnv(TorchEnv):
    DEFAULT_CONFIG = {"state_num": 10, "action_num": 6}

    def state_spec(self):
        n = int(self.config["state_num"])
        return {
            "obs:raw": ArraySpec(np.int32, (n,)),
            "obs:dyn": ArraySpec(np.float32, (-1, 2)),  # per player
            "info:queue_size": ArraySpec(np.int32, ()),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, int(self.config["action_num"]) - 1,
                                    is_discrete=True)}

    def _obs(self, state):
        counter = state["counter"]
        n = int(self.config["state_num"])
        raw = torch.arange(n, dtype=torch.int32, device=counter.device) + counter[:, None]
        p = self.max_num_players
        dyn = state["last_action"].to(torch.float32)[:, None, None].expand(-1, p, 2)
        return {
            "obs:raw": raw,
            "obs:dyn": (dyn[:, 0] if p == 1 else dyn).contiguous(),
            "info:queue_size": counter,
        }

    def reset_env(self, draws):
        del draws
        zeros = torch.zeros(self.num_envs, dtype=torch.int32, device=self.device)
        state = {"counter": zeros, "last_action": zeros}
        return state, self._obs(state)

    def step_env(self, state, action, draws):
        new_state = {"counter": state["counter"] + 1, "last_action": action.to(torch.int32)}
        return EnvOut(
            state=new_state,
            obs=self._obs(new_state),
            # The reward echoes the action (the reference's observable I/O).
            reward=action.to(torch.float32),
            terminated=new_state["counter"] >= int(self.config["state_num"]),
        )
