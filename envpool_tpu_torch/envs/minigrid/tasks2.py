"""MiniGrid task wave 2, batched over ``[N]`` envs: DynamicObstacles,
Fetch, GoToDoor, GoToObject, RedBlueDoors, Unlock(+Pickup), Memory.

Counterpart of ``envpool_tpu/envs/minigrid/tasks2.py`` (behavioural
reference ``envpool/minigrid/impl/minigrid_tasks.cc`` and
``minigrid_room_tasks.cc``); each class draws in the JAX class's order
(``plan_reset``, ``plan_step``) and builds the same grids.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...ops.batched import const
from . import core as mg
from .minigrid_env import MiniGridEnv


def _bare_grid(h: int, w: int, n: int, device) -> torch.Tensor:
    """``[N, H, W, 3]`` cells ``(EMPTY, 0, 0)`` with no border."""
    grid = np.zeros((h, w, 3), np.int8)
    grid[:, :, 0] = mg.EMPTY
    return mg.batch(grid, n, device)


class DynamicObstaclesEnv(MiniGridEnv):
    """Balls that jitter in their 3x3 box every step, one after another,
    before the agent acts; walking into anything but the goal or an empty
    cell ends the episode with reward -1.  Actions: left, right, forward."""

    DEFAULT_CONFIG = dict(MiniGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"env_name": "dynamic_obstacles", "n_obstacles": 4})

    @property
    def _nobs(self) -> int:
        size = int(self.config["size"])
        n = int(self.config["n_obstacles"])
        return n if n <= size // 2 + 1 else size // 2

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 2, is_discrete=True)}

    def plan_reset(self, d):
        w, h = self._wh
        if bool(self.config["random_start"]):
            d.cells("agent", h * w)
            d.randint("dir", 0, 4)
        for i in range(self._nobs):
            d.cells(f"ball{i}", h * w)

    def plan_step(self, d):
        """``delta`` ``[N, nobs, 2]``: each ball's move in ``{-1, 0, 1}``."""
        d.randint("delta", -1, 2, (self._nobs, 2))

    def reset_env(self, draws):
        w, h = self._wh
        grid = mg.batch(mg.empty_grid(w, h), draws["rows"].shape[0], self.device)
        grid, pos, d = self._empty_room(draws, grid)
        n = grid.shape[0]
        agent = torch.zeros((n, h, w), dtype=torch.bool, device=grid.device)
        agent[mg.rows(grid), pos[:, 1].long(), pos[:, 0].long()] = True
        obstacles = []
        for i in range(self._nobs):
            ox, oy = mg.place_random(draws[f"ball{i}"], grid, agent)
            mg.put(grid, ox, oy, mg.cell((mg.BALL, mg.BLUE, 0), grid.device))
            obstacles.append(torch.stack([ox, oy], 1))
        st = self._start(grid, pos, d)
        st["obstacles"] = torch.stack(obstacles, 1).to(torch.int32)
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        grid, pos = state["grid"], state["pos"]
        action = torch.clamp(action.to(torch.int32), 0, 2)
        w, h = self._wh
        # Collision check against the front cell before the balls move.
        fx, fy = mg.front(pos, state["dir"], w, h)
        front_obj = mg.get(grid, fx, fy)[:, 0]
        blocked = (action == mg.FORWARD) & (front_obj != mg.GOAL) & (front_obj != mg.EMPTY)
        grid = grid.clone()
        obstacles = state["obstacles"].clone()
        delta = draws["delta"]
        ball = mg.cell((mg.BALL, mg.BLUE, 0), grid.device)
        for i in range(self._nobs):
            ox, oy = obstacles[:, i, 0], obstacles[:, i, 1]
            nx = torch.clamp(ox + delta[:, i, 0], 0, w - 1)
            ny = torch.clamp(oy + delta[:, i, 1], 0, h - 1)
            ok = (mg.get(grid, nx, ny)[:, 0] == mg.EMPTY) & ~((nx == pos[:, 0]) & (ny == pos[:, 1]))
            nx = torch.where(ok, nx, ox)
            ny = torch.where(ok, ny, oy)
            mg.put(grid, ox, oy, mg.cell(mg.EMPTY_CELL, grid.device), where=ok)
            mg.put(grid, nx, ny, ball)
            obstacles[:, i] = torch.stack([nx, ny], 1)
        grid, new_pos, d, carrying, goal, lava = mg.step_agent(
            grid, pos, state["dir"], state["carrying"], action)
        t = state["t"] + 1
        reward = torch.where(blocked, -1.0,
                             torch.where(goal, mg.goal_reward(t, self.max_episode_steps), 0.0))
        st = {"grid": grid, "pos": new_pos, "dir": d, "carrying": carrying, "t": t,
              "obstacles": obstacles}
        return EnvOut(state=st, obs=self._obs(st), reward=reward.to(torch.float32),
                      terminated=blocked | goal | lava)


class FetchEnv(MiniGridEnv):
    """Fetch the named key or ball; picking up anything ends the episode."""

    DEFAULT_CONFIG = dict(MiniGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"env_name": "fetch", "num_objs": 3})

    def plan_reset(self, d):
        w, h = self._wh
        n = int(self.config["num_objs"])
        for i in range(n):
            d.bernoulli(f"is_key{i}")
            d.randint(f"color{i}", 0, 6)
            d.cells(f"obj{i}", h * w)
        d.cells("agent", h * w)
        d.randint("dir", 0, 4)
        d.randint("target", 0, n)
        d.randint("syntax", 0, 5)

    def reset_env(self, draws):
        w, h = self._wh
        k = int(self.config["num_objs"])
        n = draws["rows"].shape[0]
        grid = mg.batch(mg.empty_grid(w, h), n, self.device)
        types, colors = [], []
        for i in range(k):
            t = torch.where(draws[f"is_key{i}"], mg.KEY, mg.BALL).to(torch.int8)
            c = draws[f"color{i}"].to(torch.int8)
            ox, oy = mg.place_random(draws[f"obj{i}"], grid)
            mg.put(grid, ox, oy, mg.stack_cell(t, c))
            types.append(t)
            colors.append(c)
        ax, ay = mg.place_random(draws["agent"], grid)
        idx = draws["target"].long()[:, None]
        ttype = torch.stack(types, 1).gather(1, idx)[:, 0]
        tcolor = torch.stack(colors, 1).gather(1, idx)[:, 0]
        st = self._start(grid, torch.stack([ax, ay], 1), draws["dir"])
        st["target"] = torch.stack([ttype.to(torch.int32), tcolor.to(torch.int32),
                                    draws["syntax"]], 1)
        return st, self._obs(st)

    def _obs(self, st):
        obs = super()._obs(st)
        tt, tc, syntax = st["target"][:, 0], st["target"][:, 1], st["target"][:, 2]
        obs["info:mission_id"] = syntax * 12 + tc * 2 + (tt == mg.BALL).to(torch.int32)
        return obs

    def step_env(self, state, action, draws):
        st, _, terminated = self._step_base(state, action)
        st["target"] = state["target"]
        carrying = st["carrying"]
        picked = carrying[:, 0] != mg.EMPTY
        match = ((carrying[:, 0].to(torch.int32) == state["target"][:, 0])
                 & (carrying[:, 1].to(torch.int32) == state["target"][:, 1]))
        reward = torch.where(picked & match, mg.goal_reward(st["t"], self.max_episode_steps), 0.0)
        return EnvOut(state=st, obs=self._obs(st), reward=reward.to(torch.float32),
                      terminated=terminated | picked)


class GoToEnv(MiniGridEnv):
    """MiniGrid GoToDoor / GoToObject: ``done`` next to the target wins."""

    DEFAULT_CONFIG = dict(MiniGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"env_name": "goto_door", "num_objs": 2})

    def plan_reset(self, d):
        w, h = self._wh
        if self._name == "goto_door":
            aw = d.randint("aw", 5, w + 1)
            ah = d.randint("ah", 5, h + 1)
            d.perm("door_colors", 6)
            d.randint("top_x", 2, aw - 2)
            d.randint("bottom_x", 2, aw - 2)
            d.randint("left_y", 2, ah - 2)
            d.randint("right_y", 2, ah - 2)
            d.cells("agent", h * w)
            d.randint("target", 0, 4)
        else:
            n = int(self.config["num_objs"])
            d.perm("combos", 18)
            for i in range(n):
                d.cells(f"obj{i}", h * w)
            d.cells("agent", h * w)
            d.randint("target", 0, n)
        d.randint("dir", 0, 4)

    def reset_env(self, draws):
        w, h = self._wh
        n = draws["rows"].shape[0]
        dev = self.device
        idx = draws["target"].long()[:, None]
        if self._name == "goto_door":
            aw, ah = draws["aw"][:, None, None], draws["ah"][:, None, None]
            rows, cols = mg.iota2(h, w, dev)
            border = (rows == 0) | (cols == 0) | (rows == ah - 1) | (cols == aw - 1)
            outside = (rows >= ah) | (cols >= aw)
            grid = mg.paint(_bare_grid(h, w, n, dev), border | outside, mg.WALL_CELL)
            colors = draws["door_colors"][:, :4].to(torch.int8)
            zero = torch.zeros(n, dtype=torch.int32, device=dev)
            dpos = [(zero, draws["top_x"]), (draws["ah"] - 1, draws["bottom_x"]),
                    (draws["left_y"], zero), (draws["right_y"], draws["aw"] - 1)]
            for i, (ry, rx) in enumerate(dpos):
                mg.put(grid, rx, ry, mg.stack_cell(mg.DOOR, colors[:, i], mg.CLOSED))
            inside = (rows > 0) & (cols > 0) & (rows < ah - 1) & (cols < aw - 1)
            ax, ay = mg.place_random(draws["agent"], grid, ~inside)
            ty = torch.stack([p[0] for p in dpos], 1).gather(1, idx)[:, 0]
            tx = torch.stack([p[1] for p in dpos], 1).gather(1, idx)[:, 0]
            mission = colors.gather(1, idx)[:, 0].to(torch.int32)
        else:
            grid = mg.batch(mg.empty_grid(w, h), n, dev)
            k = int(self.config["num_objs"])
            combos = draws["combos"][:, :k]
            table = const((mg.KEY, mg.BALL, mg.BOX), dev, torch.int8)
            txs, tys = [], []
            for i in range(k):
                t = table[(combos[:, i] % 3).long()]
                c = torch.div(combos[:, i], 3, rounding_mode="floor")
                ox, oy = mg.place_random(draws[f"obj{i}"], grid)
                mg.put(grid, ox, oy, mg.stack_cell(t, c))
                txs.append(ox)
                tys.append(oy)
            ax, ay = mg.place_random(draws["agent"], grid)
            tx = torch.stack(txs, 1).gather(1, idx)[:, 0]
            ty = torch.stack(tys, 1).gather(1, idx)[:, 0]
            combo = combos.gather(1, idx)[:, 0]
            mission = torch.div(combo, 3, rounding_mode="floor") * 3 + combo % 3
        st = self._start(grid, torch.stack([ax, ay], 1), draws["dir"])
        st["target"] = torch.stack([tx, ty, mission], 1).to(torch.int32)
        return st, self._obs(st)

    def _obs(self, st):
        obs = super()._obs(st)
        obs["info:mission_id"] = st["target"][:, 2]
        return obs

    def step_env(self, state, action, draws):
        st, reward, terminated = self._step_base(state, action)
        st["target"] = state["target"]
        adjacent = ((st["pos"][:, 0] - st["target"][:, 0]).abs()
                    + (st["pos"][:, 1] - st["target"][:, 1]).abs()) == 1
        done_act = action == mg.DONE
        toggle_act = action == mg.TOGGLE
        reward = torch.where(done_act & adjacent, mg.goal_reward(st["t"], self.max_episode_steps),
                             reward)
        return EnvOut(state=st, obs=self._obs(st), reward=reward.to(torch.float32),
                      terminated=terminated | done_act | toggle_act)


class RedBlueDoorsEnv(MiniGridEnv):
    """Open the red door, then the blue one."""

    DEFAULT_CONFIG = dict(MiniGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"env_name": "red_blue_doors", "size": 8})

    @property
    def _wh(self):
        size = int(self.config["size"])
        return 2 * size, size

    def plan_reset(self, d):
        size = int(self.config["size"])
        w, h = self._wh
        d.randint("red_y", 1, size - 1)
        d.randint("blue_y", 1, size - 1)
        d.cells("agent", h * w)
        d.randint("dir", 0, 4)

    def reset_env(self, draws):
        size = int(self.config["size"])
        w, h = self._wh
        n = draws["rows"].shape[0]
        dev = self.device
        rows, cols = mg.iota2(h, w, dev)
        room_l, room_r = size // 2, size // 2 + size - 1
        border = ((rows == 0) | (rows == h - 1) | (cols == 0) | (cols == w - 1)
                  | (cols == room_l) | (cols == room_r))
        grid = mg.paint(_bare_grid(h, w, n, dev), border, mg.WALL_CELL)
        mg.put(grid, room_l, draws["red_y"], mg.cell((mg.DOOR, mg.RED, mg.CLOSED), dev))
        mg.put(grid, room_r, draws["blue_y"], mg.cell((mg.DOOR, mg.BLUE, mg.CLOSED), dev))
        inside = (rows > 0) & (rows < h - 1) & (cols > room_l) & (cols < room_r)
        ax, ay = mg.place_random(draws["agent"], grid, ~inside)
        st = self._start(grid, torch.stack([ax, ay], 1), draws["dir"])
        full = torch.full_like(draws["red_y"], room_l)
        st["doors"] = torch.stack([torch.stack([full, draws["red_y"]], 1),
                                   torch.stack([full + (room_r - room_l), draws["blue_y"]], 1)],
                                  1).to(torch.int32)
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        doors = state["doors"]

        def is_open(grid, i):
            return mg.get(grid, doors[:, i, 0], doors[:, i, 1])[:, 2] == mg.OPEN

        red_before, blue_before = is_open(state["grid"], 0), is_open(state["grid"], 1)
        st, _, terminated = self._step_base(state, action)
        st["doors"] = doors
        red_open, blue_open = is_open(st["grid"], 0), is_open(st["grid"], 1)
        success = blue_open & red_before
        fail = (blue_open & ~red_before) | (red_open & blue_before)
        reward = torch.where(success, mg.goal_reward(st["t"], self.max_episode_steps), 0.0)
        return EnvOut(state=st, obs=self._obs(st), reward=reward.to(torch.float32),
                      terminated=terminated | success | fail)


class UnlockEnv(MiniGridEnv):
    """Unlock / UnlockPickup: two rooms, a locked door, the key on the
    agent's side."""

    DEFAULT_CONFIG = dict(MiniGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update({"env_name": "unlock", "room_size": 6})

    @property
    def _wh(self):
        rs = int(self.config["room_size"])
        return 2 * rs - 1, rs

    def plan_reset(self, d):
        w, h = self._wh
        d.randint("door_y", 1, h - 1)
        d.randint("color", 0, 6)
        d.cells("key", h * w)
        if self._name == "unlock_pickup":
            d.cells("box", h * w)
            d.randint("box_color", 0, 6)
        d.cells("agent", h * w)
        d.randint("dir", 0, 4)

    def reset_env(self, draws):
        w, h = self._wh
        split = w // 2
        n = draws["rows"].shape[0]
        dev = self.device
        rows, cols = mg.iota2(h, w, dev)
        grid = mg.paint(mg.batch(mg.empty_grid(w, h), n, dev), cols == split, mg.WALL_CELL)
        color = draws["color"]
        mg.put(grid, split, draws["door_y"], mg.stack_cell(mg.DOOR, color, mg.LOCKED))
        right_side = cols >= split
        kx, ky = mg.place_random(draws["key"], grid, right_side)
        mg.put(grid, kx, ky, mg.stack_cell(mg.KEY, color))
        if self._name == "unlock_pickup":
            bx, by = mg.place_random(draws["box"], grid, cols <= split)
            mg.put(grid, bx, by, mg.stack_cell(mg.BOX, draws["box_color"]))
        ax, ay = mg.place_random(draws["agent"], grid, right_side)
        st = self._start(grid, torch.stack([ax, ay], 1), draws["dir"])
        st["door"] = torch.stack([torch.full_like(draws["door_y"], split), draws["door_y"]],
                                 1).to(torch.int32)
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        st, reward, terminated = self._step_base(state, action)
        door = state["door"]
        st["door"] = door
        if self._name == "unlock_pickup":
            success = st["carrying"][:, 0] == mg.BOX
        else:
            success = mg.get(st["grid"], door[:, 0], door[:, 1])[:, 2] == mg.OPEN
        reward = torch.where(success, mg.goal_reward(st["t"], self.max_episode_steps), reward)
        return EnvOut(state=st, obs=self._obs(st), reward=reward.to(torch.float32),
                      terminated=terminated | success)


class MemoryEnv(MiniGridEnv):
    """A hallway with an object shown at the start; step next to the
    matching object at its end.  ``pickup`` acts as ``toggle``."""

    DEFAULT_CONFIG = dict(MiniGridEnv.DEFAULT_CONFIG)
    DEFAULT_CONFIG.update(
        {"env_name": "memory", "size": 13, "random_length": False}
    )

    def plan_reset(self, d):
        size = int(self.config["size"])
        if bool(self.config["random_length"]):
            end = d.randint("hallway_end", 4, size - 2)
        else:
            end = size - 3
        d.bernoulli("start_is_key")
        d.bernoulli("first_matches")
        d.randint("agent_x", 1, end + 1)

    def reset_env(self, draws):
        size = int(self.config["size"])
        w = h = size
        mid = size // 2
        upper, lower = mid - 2, mid + 2
        n = draws["rows"].shape[0]
        dev = self.device
        if bool(self.config["random_length"]):
            end = draws["hallway_end"]
        else:
            end = torch.full((n,), size - 3, dtype=torch.int32, device=dev)
        e = end[:, None, None]
        rows, cols = mg.iota2(h, w, dev)
        border = (rows == 0) | (rows == h - 1) | (cols == 0) | (cols == w - 1)
        room_walls = ((rows == upper) | (rows == lower)) & (cols >= 1) & (cols < 5)
        narrow = ((rows == upper + 1) | (rows == lower - 1)) & ((cols == 4) | ((cols >= 5) & (cols < e)))
        end_wall = (cols == e) & (rows != mid)
        far_wall = cols == e + 2
        grid = mg.paint(mg.batch(mg.empty_grid(w, h), n, dev),
                        border | room_walls | narrow | end_wall | far_wall, mg.WALL_CELL)
        start_is_key, first_matches = draws["start_is_key"], draws["first_matches"]
        start_t = torch.where(start_is_key, mg.KEY, mg.BALL)
        other_t = torch.where(start_is_key, mg.BALL, mg.KEY)
        mg.put(grid, 1, mid - 1, mg.stack_cell(start_t, mg.GREEN))
        first_t = torch.where(first_matches, start_t, other_t)
        second_t = torch.where(first_matches, other_t, start_t)
        mg.put(grid, end + 1, mid - 2, mg.stack_cell(first_t, mg.GREEN))
        mg.put(grid, end + 1, mid + 2, mg.stack_cell(second_t, mg.GREEN))
        upper_cell = torch.stack([end + 1, torch.full_like(end, mid - 1)], 1)
        lower_cell = torch.stack([end + 1, torch.full_like(end, mid + 1)], 1)
        fm = first_matches[:, None]
        success_pos = torch.where(fm, upper_cell, lower_cell)
        failure_pos = torch.where(fm, lower_cell, upper_cell)
        pos = torch.stack([draws["agent_x"], torch.full_like(end, mid)], 1)
        st = self._start(grid, pos, torch.zeros_like(end))
        st["goal_cells"] = torch.stack([success_pos, failure_pos], 1).to(torch.int32)
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        action = torch.where(action == mg.PICKUP, mg.TOGGLE, action)
        st, _, terminated = self._step_base(state, action)
        cells = state["goal_cells"]
        st["goal_cells"] = cells
        at_success = (st["pos"] == cells[:, 0]).all(1)
        at_failure = (st["pos"] == cells[:, 1]).all(1)
        reward = torch.where(at_success, mg.goal_reward(st["t"], self.max_episode_steps), 0.0)
        return EnvOut(state=st, obs=self._obs(st), reward=reward.to(torch.float32),
                      terminated=terminated | at_success | at_failure)
