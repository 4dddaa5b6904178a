"""MiniGrid env family, batched over ``[N]`` envs: task generators and the
env class.

Counterpart of ``envpool_tpu/envs/minigrid/minigrid_env.py`` (reference
surface ``envpool/minigrid/minigrid.h``: ``obs:direction``, ``obs:image``
``[view, view, 3]`` uint8, ``info:agent_pos``, the mission as
``info:mission_id``).  Generators: Empty(+Random), DoorKey, FourRooms,
LavaGap, DistShift, SimpleCrossing/LavaCrossing.

Reward on reaching the goal: ``1 - 0.9 * t / max_steps``
(:func:`core.goal_reward`); stepping into lava terminates with 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec
from ...ops.batched import const
from . import core as mg

# Flat colour of each object index in a render.
PALETTE = (
    (0, 0, 0),        # unseen
    (0, 0, 0),        # empty → black floor
    (100, 100, 100),  # wall
    (40, 40, 40),     # floor
    (200, 150, 0),    # door
    (220, 220, 0),    # key
    (0, 0, 220),      # ball
    (120, 80, 30),    # box
    (0, 200, 0),      # goal
    (255, 80, 0),     # lava
    (255, 0, 0),      # agent
)


class MiniGridEnv(TorchEnv):
    DEFAULT_CONFIG = {
        "env_name": "empty",
        "size": 8,
        "width": 0,          # 0 → use size
        "height": 0,
        "agent_start_pos": (1, 1),
        "agent_start_dir": 0,
        "agent_view_size": 7,
        "random_start": False,
        "num_crossings": 1,
        "obstacle_type": "lava",
        "strip2_row": 2,
        "gap_pos": 0,        # 0 → random (LavaGap)
    }

    # -- config ------------------------------------------------------------

    @property
    def _wh(self) -> tuple[int, int]:
        w = int(self.config["width"]) or int(self.config["size"])
        h = int(self.config["height"]) or int(self.config["size"])
        return w, h

    @property
    def _view(self) -> int:
        return int(self.config["agent_view_size"])

    @property
    def _name(self) -> str:
        return str(self.config["env_name"])

    # -- specs -------------------------------------------------------------

    def state_spec(self):
        v = self._view
        w, h = self._wh
        bound = max(w, h, 25)
        return {
            "obs:direction": ArraySpec(np.int32, (), 0, 3, is_discrete=True),
            "obs:image": ArraySpec(np.uint8, (v, v, 3), 0, 255),
            "info:agent_pos": ArraySpec(np.int32, (2,), 0, bound),
            "info:mission_id": ArraySpec(np.int32, (), -1, 1024),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 6, is_discrete=True)}

    # -- draws -------------------------------------------------------------

    def plan_reset(self, d: mg.Draws) -> None:
        """The reset's draws, in the order :meth:`_gen`'s JAX counterpart
        makes them."""
        w, h = self._wh
        name = self._name
        if name == "empty":
            if bool(self.config["random_start"]):
                d.cells("agent", h * w)
                d.randint("dir", 0, 4)
        elif name == "doorkey":
            d.randint("split", 2, w - 2)
            d.randint("door_row", 1, h - 1)
            d.cells("key", h * w)
            d.cells("agent", h * w)
            d.randint("dir", 0, 4)
        elif name == "fourrooms":
            mid_w, mid_h = w // 2, h // 2
            for i, (lo, hi) in enumerate(((1, mid_h), (mid_h + 1, h - 1), (1, mid_w),
                                          (mid_w + 1, w - 1))):
                d.randint(f"gap{i}", lo, hi)
            d.cells("goal", h * w)
            d.cells("agent", h * w)
            d.randint("dir", 0, 4)
        elif name == "lavagap":
            if not int(self.config["gap_pos"]):
                d.randint("gap_row", 1, h - 1)
        elif name == "crossing":
            for i in range(len(self._crossing_rows())):
                d.randint(f"gap{i}", 1, w - 1)
        elif name != "distshift":
            raise ValueError(f"unknown minigrid task {name}")

    def plan_step(self, d: mg.Draws) -> None:
        """The step's draws (none)."""
        del d

    def reset_draws(self, sub):
        d = mg.Draws(sub)
        self.plan_reset(d)
        return d.out

    def step_draws(self, sub):
        d = mg.Draws(sub)
        self.plan_step(d)
        return d.out

    # -- generation --------------------------------------------------------

    def _crossing_rows(self) -> list[int]:
        w, h = self._wh
        n = int(self.config["num_crossings"])
        return [2 * (i + 1) for i in range(min(n, (h - 3) // 2))]

    def _gen(self, dr: dict):
        """Build ``(grid, pos, dir)`` for the configured task."""
        name = self._name
        w, h = self._wh
        n = dr["rows"].shape[0]
        dev = self.device
        grid = mg.batch(mg.empty_grid(w, h), n, dev)

        def corner():
            """The agent at (1, 1), facing right."""
            pos = const((1, 1), dev, torch.int32).repeat(n, 1)
            return pos, torch.zeros(n, dtype=torch.int32, device=dev)

        if name == "empty":
            return self._empty_room(dr, grid)

        rows, cols = mg.iota2(h, w, dev)
        if name == "doorkey":
            split = dr["split"][:, None, None]
            grid = mg.paint(grid, cols == split, mg.WALL_CELL)
            mg.put(grid, dr["split"], dr["door_row"], mg.cell((mg.DOOR, mg.YELLOW, mg.LOCKED), dev))
            mg.put(grid, w - 2, h - 2, mg.cell((mg.GOAL, mg.GREEN, 0), dev))
            left_only = cols >= split
            kx, ky = mg.place_random(dr["key"], grid, left_only)
            mg.put(grid, kx, ky, mg.cell((mg.KEY, mg.YELLOW, 0), dev))
            ax, ay = mg.place_random(dr["agent"], grid, left_only)
            return grid, torch.stack([ax, ay], 1), dr["dir"]

        if name == "fourrooms":
            mid_w, mid_h = w // 2, h // 2
            grid = mg.paint(grid, (cols == mid_w) | (rows == mid_h), mg.WALL_CELL)
            empty = mg.cell(mg.EMPTY_CELL, dev)
            mg.put(grid, mid_w, dr["gap0"], empty)
            mg.put(grid, mid_w, dr["gap1"], empty)
            mg.put(grid, dr["gap2"], mid_h, empty)
            mg.put(grid, dr["gap3"], mid_h, empty)
            gx, gy = mg.place_random(dr["goal"], grid)
            mg.put(grid, gx, gy, mg.cell((mg.GOAL, mg.GREEN, 0), dev))
            ax, ay = mg.place_random(dr["agent"], grid)
            return grid, torch.stack([ax, ay], 1), dr["dir"]

        if name == "lavagap":
            col = w // 2
            grid = mg.paint(grid, (cols == col) & (rows > 0) & (rows < h - 1),
                            (mg.LAVA, mg.RED, 0))
            gap = int(self.config["gap_pos"])
            mg.put(grid, col, gap if gap else dr["gap_row"], mg.cell(mg.EMPTY_CELL, dev))
            mg.put(grid, w - 2, h - 2, mg.cell((mg.GOAL, mg.GREEN, 0), dev))
            return (grid, *corner())

        if name == "distshift":
            strip = int(self.config["strip2_row"])
            grid[:, strip, 3:6] = mg.cell((mg.LAVA, mg.RED, 0), dev)
            mg.put(grid, w - 2, 1, mg.cell((mg.GOAL, mg.GREEN, 0), dev))
            return (grid, *corner())

        if name == "crossing":
            lava = str(self.config["obstacle_type"]) == "lava"
            obstacle = (mg.LAVA, mg.RED, 0) if lava else mg.WALL_CELL
            for i, row in enumerate(self._crossing_rows()):
                grid[:, row, 1:w - 1] = mg.cell(obstacle, dev)
                mg.put(grid, dr[f"gap{i}"], row, mg.cell(mg.EMPTY_CELL, dev))
            mg.put(grid, w - 2, h - 2, mg.cell((mg.GOAL, mg.GREEN, 0), dev))
            return (grid, *corner())

        raise ValueError(f"unknown minigrid task {name}")

    def _empty_room(self, dr: dict, grid: torch.Tensor):
        """The goal in the far corner of ``grid``; the agent at a random
        free cell and direction (``random_start``) or at the configured
        start: ``(grid, pos, dir)``."""
        w, h = self._wh
        n, dev = grid.shape[0], grid.device
        mg.put(grid, w - 2, h - 2, mg.cell((mg.GOAL, mg.GREEN, 0), dev))
        if bool(self.config["random_start"]):
            x, y = mg.place_random(dr["agent"], grid)
            return grid, torch.stack([x, y], 1), dr["dir"]
        pos = const(tuple(int(v) for v in self.config["agent_start_pos"]), dev,
                    torch.int32).repeat(n, 1)
        d = torch.full((n,), int(self.config["agent_start_dir"]), dtype=torch.int32, device=dev)
        return grid, pos, d

    # -- rendering ---------------------------------------------------------

    _TILE = 8  # pixels per cell

    @property
    def render_size(self):
        w, h = self._wh
        return (h * self._TILE, w * self._TILE)

    def render_state(self, state):
        """Flat-colour tiles, ``[N, H*8, W*8, 3]`` uint8 (the agent's cell
        marked)."""
        obj = state["grid"][..., 0].long().clone()
        pos = state["pos"].long()
        obj[mg.rows(obj), pos[:, 1], pos[:, 0]] = mg.AGENT
        colors = const(PALETTE, obj.device, torch.uint8)[obj]
        t = self._TILE
        return colors.repeat_interleave(t, dim=1).repeat_interleave(t, dim=2)

    # -- env contract ------------------------------------------------------

    def _obs(self, st):
        return {
            "obs:direction": st["dir"],
            "obs:image": mg.egocentric_view(st["grid"], st["pos"], st["dir"], st["carrying"],
                                            self._view),
            "info:agent_pos": st["pos"],
            "info:mission_id": torch.zeros_like(st["dir"]),
        }

    def _start(self, grid, pos, d) -> dict:
        """A fresh episode's state: empty hands, ``t`` 0."""
        n = grid.shape[0]
        return {
            "grid": grid,
            "pos": pos.to(torch.int32),
            "dir": d.to(torch.int32),
            "carrying": const((mg.EMPTY, 0), grid.device, torch.int8).repeat(n, 1),
            "t": torch.zeros(n, dtype=torch.int32, device=grid.device),
        }

    def reset_env(self, draws):
        st = self._start(*self._gen(draws))
        return st, self._obs(st)

    def _step_base(self, state, action):
        """``MiniGridEnv.step_env``'s transition: ``(state, goal reward,
        terminated)``, the state's other keys left out."""
        grid, pos, d, carrying, goal, lava = mg.step_agent(
            state["grid"], state["pos"], state["dir"], state["carrying"], action)
        t = state["t"] + 1
        reward = torch.where(goal, mg.goal_reward(t, self.max_episode_steps), 0.0)
        st = {"grid": grid, "pos": pos, "dir": d, "carrying": carrying, "t": t}
        return st, reward.to(torch.float32), goal | lava

    def step_env(self, state, action, draws):
        del draws
        st, reward, terminated = self._step_base(state, action)
        return EnvOut(state=st, obs=self._obs(st), reward=reward, terminated=terminated)
