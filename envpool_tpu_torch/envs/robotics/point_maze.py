"""PointMaze family: a force-actuated ball in a maze, goal-conditioned,
batched in PyTorch.

Counterpart of ``envpool_tpu/envs/robotics/point_maze.py`` (reference:
``envpool/mujoco/robotics/point_maze.h``, gymnasium_robotics
``envs/maze/{maze,point}.py``): a 2-dof slide-joint ball (r = 0.1, m =
4.18879 kg, damping 1, gear 100, dt = 0.01) in a grid of unit boxes; each
step clips qvel to +-5, takes MuJoCo's Euler step with implicit damping and
resolves wall contact in closed form.

The maze maps and their cell tables are the JAX package's (numpy).  The
wall resolution (two passes over the ball's cell and its 8 neighbours) is
one ``[N, 9]`` program a pass; the deepest overlap wins, the first in
(di, dj) order on ties, as in the JAX loop.  The reset cell is drawn by
rejection (centre more than 0.5 from the goal): JAX loops over
``fold_in`` keys, the port takes the first of ``ACCEPT_K`` candidates a row
(:meth:`envpool_tpu_torch.core.rng.Draws.accept`), then adds the noise; a
test hands in JAX's start position under the same name, ``start``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...core.env import EnvOut, TorchEnv
from ...core.rng import Draws
from ...core.specs import ArraySpec
from ...ops.batched import f32, inv, norm

__all__ = ["MAZE_MAPS", "PointMazeEnv"]

# Cell legend (gymnasium_robotics envs/maze/maps.py).
R, G, C = "r", "g", "c"

MAZE_MAPS: dict[str, list[list[Any]]] = {
    "OPEN": [
        [1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 0, 0, 0, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1],
    ],
    "OPEN_DIVERSE_G": [
        [1, 1, 1, 1, 1, 1, 1],
        [1, R, G, G, G, G, 1],
        [1, G, G, G, G, G, 1],
        [1, G, G, G, G, G, 1],
        [1, 1, 1, 1, 1, 1, 1],
    ],
    "OPEN_DIVERSE_GR": [
        [1, 1, 1, 1, 1, 1, 1],
        [1, C, C, C, C, C, 1],
        [1, C, C, C, C, C, 1],
        [1, C, C, C, C, C, 1],
        [1, 1, 1, 1, 1, 1, 1],
    ],
    "U_MAZE": [
        [1, 1, 1, 1, 1],
        [1, 0, 0, 0, 1],
        [1, 1, 1, 0, 1],
        [1, 0, 0, 0, 1],
        [1, 1, 1, 1, 1],
    ],
    "MEDIUM_MAZE": [
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 1, 1, 0, 0, 1],
        [1, 0, 0, 1, 0, 0, 0, 1],
        [1, 1, 0, 0, 0, 1, 1, 1],
        [1, 0, 0, 1, 0, 0, 0, 1],
        [1, 0, 1, 0, 0, 1, 0, 1],
        [1, 0, 0, 0, 1, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1],
    ],
    "MEDIUM_MAZE_DIVERSE_G": [
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, R, 0, 1, 1, 0, 0, 1],
        [1, 0, 0, 1, 0, 0, G, 1],
        [1, 1, 0, 0, 0, 1, 1, 1],
        [1, 0, 0, 1, 0, 0, 0, 1],
        [1, G, 1, 0, 0, 1, 0, 1],
        [1, 0, 0, 0, 1, G, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1],
    ],
    "MEDIUM_MAZE_DIVERSE_GR": [
        [1, 1, 1, 1, 1, 1, 1, 1],
        [1, C, 0, 1, 1, 0, 0, 1],
        [1, 0, 0, 1, 0, 0, C, 1],
        [1, 1, 0, 0, 0, 1, 1, 1],
        [1, 0, 0, 1, 0, 0, 0, 1],
        [1, C, 1, 0, 0, 1, 0, 1],
        [1, 0, 0, 0, 1, C, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1],
    ],
    "LARGE_MAZE": [
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1],
        [1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 1],
        [1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1],
        [1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1],
        [1, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 1],
        [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1],
        [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    ],
    "LARGE_MAZE_DIVERSE_G": [
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, R, 0, 0, 0, 1, G, 0, 0, 0, 0, 1],
        [1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 1],
        [1, 0, 0, 0, 0, G, 0, 1, 0, 0, G, 1],
        [1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1],
        [1, 0, G, 1, 0, 1, 0, 0, 0, 0, 0, 1],
        [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1],
        [1, 0, 0, 1, G, 0, G, 1, 0, G, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    ],
    "LARGE_MAZE_DIVERSE_GR": [
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, C, 0, 0, 0, 1, C, 0, 0, 0, 0, 1],
        [1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 1],
        [1, 0, 0, 0, 0, C, 0, 1, 0, 0, C, 1],
        [1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 0, 1],
        [1, 0, C, 1, 0, 1, 0, 0, 0, 0, 0, 1],
        [1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 1, 1],
        [1, 0, 0, 1, C, 0, C, 1, 0, C, 0, 1],
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
    ],
}

_BALL_MASS = 4000.0 / 3.0 * np.pi * 0.1**3  # sphere r=.1, density 1000
_GEAR = 100.0
_DAMPING = 1.0
_DT = 0.01
_RADIUS = 0.1
_SUCCESS_RADIUS = 0.45
# The 9 cells a wall pass checks, in the JAX loop's order.
_NEIGHBOURS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


def _maze_tables(maze_map, size_scaling):
    """(walls [H,W] bool, goal cells [Ng,2], reset cells [Nr,2]) in xy."""
    H, W = len(maze_map), len(maze_map[0])
    xc, yc = W / 2 * size_scaling, H / 2 * size_scaling
    walls = np.zeros((H, W), bool)
    goals, resets, combined, empties = [], [], [], []
    for i in range(H):
        for j in range(W):
            s = maze_map[i][j]
            x = (j + 0.5) * size_scaling - xc
            y = yc - (i + 0.5) * size_scaling
            if s == 1:
                walls[i, j] = True
            elif s == R:
                resets.append((x, y))
            elif s == G:
                goals.append((x, y))
            elif s == C:
                combined.append((x, y))
            else:
                empties.append((x, y))
    if not goals and not resets and not combined:
        combined = empties
    goals = goals + combined
    resets = resets + combined
    return (
        walls,
        np.asarray(goals, np.float32).reshape(-1, 2),
        np.asarray(resets, np.float32).reshape(-1, 2),
        (xc, yc),
    )


class PointMazeEnv(TorchEnv):
    """All PointMaze_* ids by the ``maze_map`` config."""

    DEFAULT_CONFIG = {
        "maze_map": "U_MAZE",
        "reward_type": "sparse",
        "continuing_task": True,
        "reset_target": False,
        "maze_size_scaling": 1.0,
        "maze_height": 0.4,
        "position_noise_range": 0.25,
    }

    def __init__(self, config):
        super().__init__(config)
        self.scale = float(config["maze_size_scaling"])
        walls, goals, resets, center = _maze_tables(
            MAZE_MAPS[str(config["maze_map"])], self.scale
        )
        self.walls = walls
        self.goal_cells = goals
        self.reset_cells = resets
        self.center = center
        self.noise = float(config["position_noise_range"]) * self.scale
        self.sparse = str(config["reward_type"]) == "sparse"
        self.continuing = bool(config["continuing_task"])
        self.reset_target = bool(config["reset_target"])
        dev = self.device
        self._walls = torch.as_tensor(walls, device=dev)
        self._goals = torch.as_tensor(goals, device=dev)
        self._resets = torch.as_tensor(resets, device=dev)
        self._di = torch.as_tensor([d[0] for d in _NEIGHBOURS], device=dev)
        self._dj = torch.as_tensor([d[1] for d in _NEIGHBOURS], device=dev)

    # -- specs ------------------------------------------------------------------

    def state_spec(self):
        inf = float("inf")
        return {
            "obs:observation": ArraySpec(np.float32, (4,), -inf, inf),
            "obs:achieved_goal": ArraySpec(np.float32, (2,), -inf, inf),
            "obs:desired_goal": ArraySpec(np.float32, (2,), -inf, inf),
            "info:success": ArraySpec(np.float32, (), 0.0, 1.0),
            "info:distance": ArraySpec(np.float32, (), 0.0, inf),
            "info:qpos0": ArraySpec(np.float32, (2,)),
            "info:qvel0": ArraySpec(np.float32, (2,)),
            "info:goal0": ArraySpec(np.float32, (2,)),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (2,), -1.0, 1.0)}

    # -- draws ------------------------------------------------------------------

    def _plan_goal(self, d, prefix):
        d.randint(prefix + "cell", 0, len(self.goal_cells))
        d.uniform(prefix + "noise", (2,), -self.noise, self.noise)

    def _goal(self, draws, prefix):
        return self._goals[draws[prefix + "cell"].long()] + draws[prefix + "noise"]

    def plan_reset(self, d):
        """The reset's draws, in the JAX env's order: the goal's cell and
        noise, then the start (a reset cell whose centre lies more than 0.5
        from the goal, plus noise)."""
        self._plan_goal(d, "goal_")
        goal = self._goal(d.out, "goal_")
        cells = self._resets
        d.accept("start", lambda s, k: self._start(s, k, cells),
                 lambda c: norm(c[..., 2:] - goal[:, None]) > 0.5)

    def _start(self, d, k, cells):
        """``[N, k, 4]``: the noisy start (``[..., :2]``) of ``k`` candidate
        reset cells (their centres ``[..., 2:]``, which the predicate
        reads)."""
        centre = cells[d.randint("cell", 0, len(cells), (k,)).long()]
        noise = d.uniform("noise", (k, 2), -self.noise, self.noise)
        return torch.cat([centre + noise, centre], -1)

    def plan_step(self, d):
        """The step's draws: a new goal for the continuing task."""
        if self.continuing and len(self.goal_cells) > 1 and not self.reset_target:
            self._plan_goal(d, "next_")

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    def step_draws(self, sub):
        d = Draws(sub)
        self.plan_step(d)
        return d.out

    # -- helpers ----------------------------------------------------------------

    def _cell_of(self, xy):
        """World xy ``[N, 2]`` -> (row, col) cell indices ``[N]``."""
        xc, yc = self.center
        j = torch.floor((xy[:, 0] + f32(xc)) * inv(self.scale)).to(torch.int32)
        i = torch.floor((f32(yc) - xy[:, 1]) * inv(self.scale)).to(torch.int32)
        H, W = self.walls.shape
        return torch.clamp(i, 0, H - 1), torch.clamp(j, 0, W - 1)

    def _resolve_walls(self, pos, vel):
        """Push the ball out of any blocked cell's expanded box (two passes):
        the deepest overlap of the ball's cell and its 8 neighbours, along
        its smaller penetration, zeroing that velocity component."""
        xc, yc = self.center
        H, W = self.walls.shape
        half = 0.5 * self.scale
        for _ in range(2):
            ci, cj = self._cell_of(pos)
            i = torch.clamp(ci[:, None] + self._di, 0, H - 1)                 # [N, 9]
            j = torch.clamp(cj[:, None] + self._dj, 0, W - 1)
            is_wall = self._walls[i.long(), j.long()]
            wx = (j.to(torch.float32) + 0.5) * f32(self.scale) - f32(xc)
            wy = f32(yc) - (i.to(torch.float32) + 0.5) * f32(self.scale)
            dx = pos[:, :1] - wx
            dy = pos[:, 1:] - wy
            pen_x = f32(half + _RADIUS) - torch.abs(dx)
            pen_y = f32(half + _RADIUS) - torch.abs(dy)
            overlap = is_wall & (pen_x > 0) & (pen_y > 0)
            use_x = pen_x < pen_y
            depth = torch.where(use_x, pen_x, pen_y)
            # The first strictly deeper overlap in the loop's order: the
            # deepest, the first of equals.
            score = torch.where(overlap, depth, -1.0)
            best = score.max(1, keepdim=True).values
            k = torch.where((score == best) & overlap, torch.arange(9, device=pos.device),
                            9).min(1, keepdim=True).values.clamp_max(8)
            hit = (best[:, 0] > 0)
            bx = use_x.gather(1, k)[:, 0]
            push_x = torch.where(bx, torch.sign(dx.gather(1, k)[:, 0]) * pen_x.gather(1, k)[:, 0],
                                 0.0)
            push_y = torch.where(bx, 0.0,
                                 torch.sign(dy.gather(1, k)[:, 0]) * pen_y.gather(1, k)[:, 0])
            pos = torch.where(hit[:, None], pos + torch.stack([push_x, push_y], 1), pos)
            vel = torch.stack([torch.where(hit & bx, 0.0, vel[:, 0]),
                               torch.where(hit & ~bx, 0.0, vel[:, 1])], 1)
        return pos, vel

    # -- the env ------------------------------------------------------------------

    def _obs(self, st):
        pos, vel, goal = st["pos"], st["vel"], st["goal"]
        d = norm(pos - goal)
        return {
            "obs:observation": torch.cat([pos, vel], 1),
            "obs:achieved_goal": pos,
            "obs:desired_goal": goal,
            "info:success": (d <= _SUCCESS_RADIUS).to(torch.float32),
            "info:distance": d,
            "info:qpos0": st["qpos0"],
            "info:qvel0": torch.zeros_like(vel),
            "info:goal0": st["goal0"],
        }

    def reset_env(self, draws):
        goal = self._goal(draws, "goal_")
        pos = draws["start"][:, :2]
        st = {"pos": pos, "vel": torch.zeros_like(pos), "goal": goal, "qpos0": pos,
              "goal0": goal}
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        action = torch.clamp(action.reshape(-1, 2).to(torch.float32), -1.0, 1.0)
        pos, vel = state["pos"], state["vel"]
        # The velocity clip comes before the sim step (point.py:_clip_velocity).
        vel = torch.clamp(vel, -5.0, 5.0)
        # MuJoCo Euler with implicit joint damping: (m + h d) v' = m v + h F.
        force = action * _GEAR
        vel = (f32(_BALL_MASS) * vel + _DT * force) * inv(_BALL_MASS + _DT * _DAMPING)
        pos = pos + _DT * vel
        pos, vel = self._resolve_walls(pos, vel)

        d = norm(pos - state["goal"])
        success = d <= _SUCCESS_RADIUS
        reward = success.to(torch.float32) if self.sparse else torch.exp(-d)
        goal = state["goal"]
        terminated = torch.zeros_like(success)
        if self.continuing:
            # A new goal on success (unless reset_target or a single goal
            # cell): maze.py compute_terminated.
            if len(self.goal_cells) > 1 and not self.reset_target:
                goal = torch.where(success[:, None], self._goal(draws, "next_"), goal)
        else:
            terminated = success
        st = {"pos": pos, "vel": vel, "goal": goal, "qpos0": state["qpos0"],
              "goal0": state["goal0"]}
        return EnvOut(state=st, obs=self._obs(st), reward=reward, terminated=terminated)
