"""Grid-engine procgen games, batched over ``[N]`` envs: maze, heist,
chaser, miner.

Counterpart of ``envpool_tpu/envs/procgen/grid_games.py``.  Integer state
and exact renders.  Each game's ``init_draws(sub)`` / ``tick_draws(sub)``
make the draws its ``init(draws)`` / ``tick(g, action, draws)`` consume.
"""

from __future__ import annotations

import torch

from ...core import rng
from ...ops.batched import const, first_argmax
from .core import (
    BANK_SIZE,
    decode_action,
    gather_cell,
    maze_bank,
    paint_cell,
    render_grid,
    set_cell,
)

_WALL = (60.0, 60.0, 60.0)
_FLOOR = (180.0, 170.0, 150.0)
_AGENT = (40.0, 90.0, 220.0)
_GOAL = (240.0, 210.0, 40.0)
_KEY_RGB = ((230.0, 60.0, 60.0), (60.0, 200.0, 60.0), (60.0, 60.0, 230.0))
_DIRT = (120.0, 85.0, 50.0)
_DIAMOND = (120.0, 220.0, 240.0)
_BOULDER = (130.0, 130.0, 130.0)
_ENEMY = (220.0, 60.0, 60.0)
_DOT = (250.0, 240.0, 200.0)
_DARK = (25.0, 25.0, 35.0)
_MINE = (30.0, 25.0, 20.0)


class GridGame:
    """Shared: agent on an ``[n, n]`` grid; one move per step."""

    extra_open: float | None = None  # the maze bank's, where the game has one

    def __init__(self, size: int, mode: str, device: torch.device):
        self.n = size
        self.mode = mode
        self.device = device
        if self.extra_open is not None:
            self.bank = torch.tensor(maze_bank(size, self.extra_open), device=device)

    def init_draws(self, sub):
        """``maze`` ``[N]``: one bank layout per level."""
        return {"maze": rng.randint(sub, 0, BANK_SIZE)}

    def tick_draws(self, sub):
        del sub
        return {}

    def _start(self, n):
        return torch.ones(n, 2, dtype=torch.int32, device=self.device)

    def move_agent(self, walls, pos, dx, dy):
        # Grid coords: (row, col); dy up = row-1.
        nr = torch.clamp(pos[:, 0] - dy, 0, self.n - 1)
        nc = torch.clamp(pos[:, 1] + dx, 0, self.n - 1)
        blocked = gather_cell(walls, nr, nc)
        return torch.where(blocked[:, None], pos, torch.stack([nr, nc], 1)).to(torch.int32)

    def _cells(self, mask, on, off):
        return torch.where(mask[..., None], const(on, self.device), const(off, self.device))


class MazeGame(GridGame):
    """maze: reach the goal cell (+10, episode ends)."""

    def __init__(self, size, mode, device):
        self.extra_open = 0.1 if mode == "easy" else 0.0
        super().__init__(size, mode, device)

    def init(self, d, N):
        walls = self.bank[d["maze"].long()]
        n = self.n
        # Goal: the first open cell of largest row + col; agent at (1, 1).
        rows = torch.arange(n, device=self.device)
        dist = (rows[:, None] + rows[None, :]).reshape(-1)
        score = torch.where(~walls.reshape(-1, n * n), dist, -1)
        gi = first_argmax(score)
        return {
            "walls": walls,
            "pos": self._start(N),
            "goal": torch.stack([gi // n, gi % n], 1).to(torch.int32),
        }

    def tick(self, g, action, d):
        dx, dy, _ = decode_action(action)
        pos = self.move_agent(g["walls"], g["pos"], dx, dy)
        done = (pos == g["goal"]).all(1)
        reward = torch.where(done, 10.0, 0.0)
        return {**g, "pos": pos}, reward, done

    def render(self, g):
        cells = self._cells(g["walls"], _WALL, _FLOOR)
        paint_cell(cells, g["goal"][:, 0], g["goal"][:, 1], _GOAL)
        paint_cell(cells, g["pos"][:, 0], g["pos"][:, 1], _AGENT)
        return render_grid(cells)


class HeistGame(GridGame):
    """heist: collect keys in colour order, open the vault (+10)."""

    N_KEYS = 3
    extra_open = 0.15

    def init_draws(self, sub):
        """``maze`` ``[N]`` and ``spots`` ``[N, 4]``: the flat cells of the
        three keys and the vault, drawn one after another uniformly from the
        layout's open cells that are neither the agent's nor taken (JAX
        draws them with ``jax.random.choice`` over the same cells)."""
        maze = rng.randint(sub, 0, BANK_SIZE)
        n = self.n
        free = (~self.bank[maze.long()]).reshape(-1, n * n).to(torch.int64)
        free[:, n + 1] = 0  # not on the agent
        u = rng.uniform(sub, 1, self.N_KEYS + 1).to(torch.float64)
        spots = []
        for i in range(self.N_KEYS + 1):
            count = free.sum(1)
            k = torch.minimum((u[:, i] * count).to(torch.int64), count - 1)
            idx = (free.cumsum(1) <= k[:, None]).sum(1)
            free = free.scatter(1, idx[:, None], 0)
            spots.append(idx)
        return {"maze": maze, "spots": torch.stack(spots, 1).to(torch.int32)}

    def init(self, d, N):
        walls = self.bank[d["maze"].long()]
        n = self.n
        spots = torch.stack([d["spots"] // n, d["spots"] % n], 2).to(torch.int32)
        return {
            "walls": walls,
            "pos": self._start(N),
            "keys": spots[:, :-1].contiguous(),
            "vault": spots[:, -1].contiguous(),
            "have": torch.zeros(N, self.N_KEYS, dtype=torch.bool, device=self.device),
        }

    def tick(self, g, action, d):
        dx, dy, _ = decode_action(action)
        pos = self.move_agent(g["walls"], g["pos"], dx, dy)
        have = list(g["have"].unbind(1))
        for i in range(self.N_KEYS):
            on_key = (pos == g["keys"][:, i]).all(1)
            # Keys must be taken in order (lock hierarchy).
            have[i] = have[i] | (on_key if i == 0 else on_key & have[i - 1])
        have = torch.stack(have, 1)
        done = (pos == g["vault"]).all(1) & have.all(1)
        reward = torch.where(done, 10.0, 0.0)
        return {**g, "pos": pos, "have": have}, reward, done

    def render(self, g):
        cells = self._cells(g["walls"], _WALL, _FLOOR)
        for i in range(self.N_KEYS):
            rgb = torch.where(g["have"][:, i, None], const(_FLOOR, self.device),
                              const(_KEY_RGB[i], self.device))
            paint_cell(cells, g["keys"][:, i, 0], g["keys"][:, i, 1], rgb)
        paint_cell(cells, g["vault"][:, 0], g["vault"][:, 1], _GOAL)
        paint_cell(cells, g["pos"][:, 0], g["pos"][:, 1], _AGENT)
        return render_grid(cells)


class ChaserGame(GridGame):
    """chaser: eat dots (+0.5 each), avoid chasing enemies; all dots
    cleared +10."""

    N_ENEMIES = 3
    extra_open = 0.35

    def init_draws(self, sub):
        """``maze`` ``[N]``; ``enemies`` ``[N, 3, 2]`` uniform in
        ``[n // 2, n - 2)``."""
        lo, hi = self.n // 2, self.n - 2
        e = lo + rng.randint(sub, 1, hi - lo, 2 * self.N_ENEMIES)
        return {"maze": rng.randint(sub, 0, BANK_SIZE),
                "enemies": e.reshape(-1, self.N_ENEMIES, 2)}

    def tick_draws(self, sub):
        """``u`` ``[N, 3]`` uniform: each enemy moves along its row where
        ``u < 0.5``, else along its column."""
        return {"u": rng.uniform(sub, 0, self.N_ENEMIES)}

    def init(self, d, N):
        walls = self.bank[d["maze"].long()]
        dots = ~walls
        dots[:, 1, 1] = False
        return {
            "walls": walls,
            "pos": self._start(N),
            "dots": dots,
            "enemies": d["enemies"].to(torch.int32),
            "scared": torch.zeros(N, dtype=torch.int32, device=self.device),
        }

    def tick(self, g, action, d):
        dx, dy, _ = decode_action(action)
        walls = g["walls"]
        pos = self.move_agent(walls, g["pos"], dx, dy)
        ate = gather_cell(g["dots"], pos[:, 0], pos[:, 1])
        dots = set_cell(g["dots"], pos[:, 0], pos[:, 1], False)
        reward = torch.where(ate, 0.5, 0.0)
        # Enemies: greedy chase, along the row or the column by a draw.
        enemies = []
        caught = torch.zeros_like(ate)
        for i in range(self.N_ENEMIES):
            e = g["enemies"][:, i]
            dr = torch.sign(pos[:, 0] - e[:, 0])
            dc = torch.sign(pos[:, 1] - e[:, 1])
            use_row = d["u"][:, i] < 0.5
            nr = torch.clamp(e[:, 0] + torch.where(use_row, dr, 0), 0, self.n - 1)
            nc = torch.clamp(e[:, 1] + torch.where(use_row, 0, dc), 0, self.n - 1)
            blocked = gather_cell(walls, nr, nc)
            ne = torch.where(blocked[:, None], e, torch.stack([nr, nc], 1)).to(torch.int32)
            enemies.append(ne)
            caught = caught | (ne == pos).all(1)
        cleared = ~dots.flatten(1).any(1)
        reward = reward + torch.where(cleared, 10.0, 0.0)
        done = caught | cleared
        reward = torch.where(caught, 0.0, reward)
        return (
            {**g, "pos": pos, "dots": dots, "enemies": torch.stack(enemies, 1)},
            reward,
            done,
        )

    def render(self, g):
        cells = self._cells(g["walls"], _WALL, _DARK)
        cells = torch.where((g["dots"] & ~g["walls"])[..., None], const(_DOT, self.device),
                            cells)
        for i in range(self.N_ENEMIES):
            paint_cell(cells, g["enemies"][:, i, 0], g["enemies"][:, i, 1], _ENEMY)
        paint_cell(cells, g["pos"][:, 0], g["pos"][:, 1], _AGENT)
        return render_grid(cells)


class MinerGame(GridGame):
    """miner (boulderdash): dig dirt, collect diamonds (+1), reach the
    exit after all diamonds (+10); falling boulders kill."""

    def init_draws(self, sub):
        """``u``, ``v`` ``[N, n, n]`` uniform: a boulder where ``u < 0.12``,
        a diamond where ``v < 0.08`` and there is no boulder."""
        nn = self.n * self.n
        return {"u": rng.uniform(sub, 0, nn).reshape(-1, self.n, self.n),
                "v": rng.uniform(sub, nn, nn).reshape(-1, self.n, self.n)}

    def init(self, d, N):
        n = self.n
        # World: dirt everywhere, boulders and diamonds sprinkled.
        dirt = torch.ones(N, n, n, dtype=torch.bool, device=self.device)
        dirt[:, 1, 1] = False
        boulders = d["u"] < 0.12
        diamonds = (d["v"] < 0.08) & ~boulders
        boulders[:, 1, 1] = False
        boulders[:, 0, :] = False
        diamonds[:, 1, 1] = False
        diamonds[:, n - 2, n - 2] = False
        boulders[:, n - 2, n - 2] = False
        return {
            "pos": self._start(N),
            "dirt": dirt,
            "boulders": boulders,
            "diamonds": diamonds,
            "exit": torch.full((N, 2), n - 2, dtype=torch.int32, device=self.device),
        }

    def tick(self, g, action, d):
        dx, dy, _ = decode_action(action)
        nr = torch.clamp(g["pos"][:, 0] - dy, 0, self.n - 1)
        nc = torch.clamp(g["pos"][:, 1] + dx, 0, self.n - 1)
        blocked = gather_cell(g["boulders"], nr, nc)
        pos = torch.where(blocked[:, None], g["pos"], torch.stack([nr, nc], 1)).to(torch.int32)
        r, c = pos[:, 0], pos[:, 1]
        dirt = set_cell(g["dirt"], r, c, False)
        got = gather_cell(g["diamonds"], r, c)
        diamonds = set_cell(g["diamonds"], r, c, False)
        reward = torch.where(got, 1.0, 0.0)
        # Boulder gravity: fall into empty (no dirt, no boulder) cells.
        below_empty = ~dirt & ~g["boulders"]
        can_fall = g["boulders"] & torch.roll(below_empty, -1, 1)
        can_fall[:, -1, :] = False
        boulders = (g["boulders"] & ~can_fall) | torch.roll(can_fall, 1, 1)
        crushed = gather_cell(boulders, r, c)
        all_got = ~diamonds.flatten(1).any(1)
        win = all_got & (pos == g["exit"]).all(1)
        reward = reward + torch.where(win, 10.0, 0.0)
        done = crushed | win
        return (
            {**g, "pos": pos, "dirt": dirt, "boulders": boulders, "diamonds": diamonds},
            reward,
            done,
        )

    def render(self, g):
        base = self._cells(g["dirt"], _DIRT, _MINE)
        base = torch.where(g["boulders"][..., None], const(_BOULDER, self.device), base)
        base = torch.where(g["diamonds"][..., None], const(_DIAMOND, self.device), base)
        paint_cell(base, g["exit"][:, 0], g["exit"][:, 1], _GOAL)
        paint_cell(base, g["pos"][:, 0], g["pos"][:, 1], _AGENT)
        return render_grid(base)
