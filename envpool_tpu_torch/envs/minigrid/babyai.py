"""BabyAI single-room tasks, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/minigrid/babyai.py`` (behavioural
reference ``envpool/minigrid/impl/babyai_*.cc``):

* :class:`BabyAIGoToEnv`: GoToObj ("go to the <color> <type>": success
  when the agent faces it) and GoToDoor (four doors of distinct colours;
  ``done`` while facing the named one).  Mission id ``color * 8 + type``.
* :class:`BabyAILocalEnv`: GoToRedBall(Grey/NoDists), GoToRedBlueBall,
  GoToLocal: success when the front cell holds any object matching the
  instruction's (type, color).
"""

from __future__ import annotations

import torch

from ...core.env import EnvOut
from ...ops.batched import const, first_argmax
from . import core as mg
from .minigrid_env import MiniGridEnv

_OBJ_TYPES = (mg.KEY, mg.BALL, mg.BOX)


class BabyAIGoToEnv(MiniGridEnv):
    """GoToObj / GoToDoor with mission ids."""

    DEFAULT_CONFIG = dict(MiniGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"env_name": "goto_obj", "size": 8})

    def plan_reset(self, d):
        w, h = self._wh
        if self._name == "goto_obj":
            d.choice("type", _OBJ_TYPES)
            d.randint("color", 0, 6)
            d.cells("obj", h * w)
            d.cells("agent", h * w)
            d.randint("dir", 0, 4)
        elif self._name == "goto_door":
            d.perm("colors", 6)
            d.randint("dy", 1, h - 1, (2,))
            d.randint("dx", 1, w - 1, (2,))
            d.cells("agent", h * w)
            d.randint("dir", 0, 4)
            d.cells("target", h * w)
        else:
            super().plan_reset(d)

    def _gen(self, dr):
        w, h = self._wh
        n = dr["rows"].shape[0]
        dev = self.device
        grid = mg.batch(mg.empty_grid(w, h), n, dev)
        if self._name == "goto_obj":
            ox, oy = mg.place_random(dr["obj"], grid)
            mg.put(grid, ox, oy, mg.stack_cell(dr["type"], dr["color"]))
        elif self._name == "goto_door":
            colors = dr["colors"][:, :4]
            zero = torch.zeros(n, dtype=torch.int32, device=dev)
            for i, (ry, rx) in enumerate(((zero, dr["dx"][:, 0]), (zero + h - 1, dr["dx"][:, 1]),
                                          (dr["dy"][:, 0], zero), (dr["dy"][:, 1], zero + w - 1))):
                mg.put(grid, rx, ry, mg.stack_cell(mg.DOOR, colors[:, i], mg.CLOSED))
        else:
            return super()._gen(dr)
        ax, ay = mg.place_random(dr["agent"], grid)
        return grid, torch.stack([ax, ay], 1), dr["dir"]

    def _mission(self, grid, target):
        c = mg.get(grid, target[:, 0], target[:, 1])
        return c[:, 1].to(torch.int32) * 8 + c[:, 0].to(torch.int32)

    def reset_env(self, draws):
        st = self._start(*self._gen(draws))
        obj = st["grid"][..., 0].reshape(st["grid"].shape[0], -1)
        w = st["grid"].shape[2]
        if self._name == "goto_door":
            idx = mg.pick(draws["target"], obj == mg.DOOR)
        else:
            idx = first_argmax(((obj == mg.KEY) | (obj == mg.BALL) | (obj == mg.BOX)).to(torch.int8))
        st["target"] = torch.stack([idx % w, idx // w], 1).to(torch.int32)
        obs = MiniGridEnv._obs(self, st)
        obs["info:mission_id"] = self._mission(st["grid"], st["target"])
        return st, obs

    def step_env(self, state, action, draws):
        st, reward, terminated = self._step_base(state, action)
        st["target"] = state["target"]
        fwd = st["pos"] + const(mg.DIR_VEC, st["pos"].device, torch.int32)[st["dir"].long()]
        success = (fwd == st["target"]).all(1)
        if self._name == "goto_door":
            success = success & (action == mg.DONE)
        reward = torch.where(success, mg.goal_reward(st["t"], self.max_episode_steps), reward)
        obs = MiniGridEnv._obs(self, st)
        obs["info:mission_id"] = self._mission(st["grid"], st["target"])
        return EnvOut(state=st, obs=obs, reward=reward.to(torch.float32),
                      terminated=terminated | success)


class BabyAILocalEnv(MiniGridEnv):
    """Single-room BabyAI levels with description-matched GoTo
    instructions: any object matching (type, color) in front counts.

    Distractors are uniform (type, color) draws; the Grey variant recolours
    them grey, and GoToRedBlueBall recolours red or blue ball distractors
    grey.  Mission id ``color * 8 + type``."""

    DEFAULT_CONFIG = dict(MiniGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update(
        {"env_name": "goto_red_ball", "size": 8, "num_dists": 7}
    )

    def plan_reset(self, d):
        w, h = self._wh
        n = int(self.config["num_dists"])
        if self._name in ("goto_red_ball", "goto_red_ball_grey"):
            d.cells("target_cell", h * w)
        elif self._name == "goto_red_blue_ball":
            d.bernoulli("red")
            d.cells("target_cell", h * w)
        for i in range(n):
            d.randint(f"type{i}", 0, 3)
            d.randint(f"color{i}", 0, 6)
            d.cells(f"dist{i}", h * w)
        if self._name == "goto_local":
            d.randint("target", 0, n)
        d.cells("agent", h * w)
        d.randint("dir", 0, 4)

    def reset_env(self, draws):
        w, h = self._wh
        k = int(self.config["num_dists"])
        n = draws["rows"].shape[0]
        dev = self.device
        grid = mg.batch(mg.empty_grid(w, h), n, dev)
        name = self._name
        if name != "goto_local":
            ttype = torch.full((n,), mg.BALL, dtype=torch.int32, device=dev)
            tcolor = torch.full((n,), mg.RED, dtype=torch.int32, device=dev)
            if name == "goto_red_blue_ball":
                tcolor = torch.where(draws["red"], mg.RED, mg.BLUE).to(torch.int32)
            ox, oy = mg.place_random(draws["target_cell"], grid)
            mg.put(grid, ox, oy, mg.stack_cell(mg.BALL, tcolor))
        table = const(_OBJ_TYPES, dev, torch.int8)
        types, colors = [], []
        for i in range(k):
            t = table[draws[f"type{i}"].long()]
            c = draws[f"color{i}"].to(torch.int8)
            if name == "goto_red_ball_grey":
                c = torch.full_like(c, mg.GREY)
            elif name == "goto_red_blue_ball":
                clash = (t == mg.BALL) & ((c == mg.RED) | (c == mg.BLUE))
                c = torch.where(clash, mg.GREY, c).to(torch.int8)
            dx, dy = mg.place_random(draws[f"dist{i}"], grid)
            mg.put(grid, dx, dy, mg.stack_cell(t, c))
            types.append(t)
            colors.append(c)
        if name == "goto_local":
            idx = draws["target"].long()[:, None]
            ttype = torch.stack(types, 1).gather(1, idx)[:, 0].to(torch.int32)
            tcolor = torch.stack(colors, 1).gather(1, idx)[:, 0].to(torch.int32)
        ax, ay = mg.place_random(draws["agent"], grid)
        st = self._start(grid, torch.stack([ax, ay], 1), draws["dir"])
        st["target"] = torch.stack([ttype, tcolor], 1).to(torch.int32)
        return st, self._obs(st)

    def _obs(self, st):
        obs = super()._obs(st)
        obs["info:mission_id"] = st["target"][:, 1] * 8 + st["target"][:, 0]
        return obs

    def step_env(self, state, action, draws):
        st, reward, terminated = self._step_base(state, action)
        st["target"] = state["target"]
        w, h = self._wh
        c = mg.get(st["grid"], *mg.front(st["pos"], st["dir"], w, h))
        success = ((c[:, 0].to(torch.int32) == state["target"][:, 0])
                   & (c[:, 1].to(torch.int32) == state["target"][:, 1]))
        reward = torch.where(success, mg.goal_reward(st["t"], self.max_episode_steps), reward)
        return EnvOut(state=st, obs=self._obs(st), reward=reward.to(torch.float32),
                      terminated=terminated | success)
