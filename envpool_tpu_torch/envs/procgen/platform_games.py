"""Platformer-engine procgen games, batched over ``[N]`` envs: coinrun,
ninja, jumper, climber, leaper.

Counterpart of ``envpool_tpu/envs/procgen/platform_games.py``: one
``[_N, _N]`` tile world with gravity and jump kinematics (float
positions); goal objects grant +10 and end the episode.  Leaper is
frogger-style lanes (no gravity).
"""

from __future__ import annotations

import torch

from ...core import rng
from ...ops.batched import const, mod
from .core import decode_action, paint_cell, render_grid

_N = 16  # tile grid (rendered 4 px per tile)
_SKY = (140.0, 185.0, 235.0)
_GROUND = (90.0, 60.0, 35.0)
_COIN = (250.0, 210.0, 50.0)
_AGENT = (230.0, 70.0, 70.0)
_HAZARD = (40.0, 40.0, 40.0)
_STAR = (250.0, 250.0, 250.0)
_GRASS = (70.0, 130.0, 70.0)
_ROAD = (80.0, 80.0, 85.0)


def _terrain_draws(sub, slot: int = 0) -> dict:
    """``steps`` ``[N, _N]`` uniform in {-1, 0, 1}; ``gaps`` and
    ``hazards`` ``[N, _N]`` uniform in ``[0, 1)``."""
    return {"steps": rng.randint(sub, slot, 3, _N) - 1,
            "gaps": rng.uniform(sub, slot + _N, _N),
            "hazards": rng.uniform(sub, slot + 2 * _N, _N)}


def _terrain(d, gap_p: float, max_h: int):
    """Column heights + hazard flags for a side-scrolling level."""
    heights = torch.clamp(3 + torch.cumsum(d["steps"], 1), 2, 2 + max_h).to(torch.int32)
    heights[:, 0] = 3
    gaps = d["gaps"] < gap_p
    gaps[:, 0] = gaps[:, _N - 1] = False
    hazards = d["hazards"] < gap_p
    hazards[:, 0] = hazards[:, _N - 1] = False
    return heights, gaps, hazards & ~gaps


def _col(x: torch.Tensor) -> torch.Tensor:
    """The tile column of ``x`` (truncated, as ``astype(int32)``)."""
    return torch.clamp(x.to(torch.int32), 0, _N - 1)


def _at(row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """``row[i, col[i]]`` of an ``[N, _N]`` tensor."""
    return row.gather(1, col.long()[:, None])[:, 0]


class _PlatformBase:
    def __init__(self, size: int, mode: str, device: torch.device):
        self.mode = mode
        self.device = device
        self.gap_p = 0.25 if mode in ("hard", "extreme") else 0.12

    def init_draws(self, sub):
        return _terrain_draws(sub)

    def tick_draws(self, sub):
        del sub
        return {}

    def _scalars(self, n, **values):
        return {k: torch.full((n,), v, device=self.device,
                              dtype=torch.float32 if isinstance(v, float) else torch.int32)
                for k, v in values.items()}

    def physics(self, g, dx, jump):
        """Shared gravity/jump step on (x, y, vy)."""
        x = torch.clamp(g["x"] + 0.4 * dx.to(torch.float32), 0.0, _N - 1.0)
        col = _col(x)
        floor = torch.where(_at(g["gaps"], col), -2.0, _at(g["heights"], col).to(torch.float32))
        on_ground = g["y"] <= floor + 0.05
        vy = torch.where(jump & on_ground, 1.4, g["vy"] - 0.18)
        y = g["y"] + vy
        landed = (y <= floor) & (vy <= 0)
        y = torch.where(landed, floor, y)
        vy = torch.where(landed, 0.0, vy)
        return x, y, vy, col

    def _sky(self, n, rgb=_SKY):
        return const(rgb, self.device).expand(n, _N, _N, 3).clone()

    def _ground(self, g):
        """Sky over the terrain's ground columns: (cells, column heights)."""
        cells = self._sky(g["x"].shape[0])
        rows = torch.arange(_N, device=self.device)[None, :, None]
        h = g["heights"][:, None, :]
        gap = g["gaps"][:, None, :]
        ground = (rows >= _N - h) & ~gap
        cells = torch.where(ground[..., None], const(_GROUND, self.device), cells)
        return cells, rows, h, gap

    def _agent(self, cells, g):
        ar = torch.clamp(_N - 1 - g["y"].to(torch.int32), 0, _N - 1)
        paint_cell(cells, ar, _col(g["x"]), _AGENT)
        return render_grid(cells)


class CoinrunGame(_PlatformBase):
    """Run right, jump gaps/hazards, grab the coin (+10)."""

    def init(self, d, n):
        heights, gaps, hazards = _terrain(d, self.gap_p, 4)
        return {**self._scalars(n, x=0.0, y=3.0, vy=0.0),
                "heights": heights, "gaps": gaps, "hazards": hazards}

    def tick(self, g, action, d):
        dx, dy, sp = decode_action(action)
        jump = (dy > 0) | (sp == 1)
        x, y, vy, col = self.physics(g, dx, jump)
        fell = y < -1.0
        on_hazard = _at(g["hazards"], col) & (y <= _at(g["heights"], col).to(torch.float32) + 0.1)
        win = x >= _N - 1.5
        reward = torch.where(win, 10.0, 0.0)
        return {**g, "x": x, "y": y, "vy": vy}, reward, fell | on_hazard | win

    def render(self, g):
        cells, rows, h, gap = self._ground(g)
        hz = g["hazards"][:, None, :] & (rows == _N - h - 1) & ~gap
        cells = torch.where(hz[..., None], const(_HAZARD, self.device), cells)
        cells[:, :, _N - 1] = const(_COIN, self.device)
        return self._agent(cells, g)


class NinjaGame(CoinrunGame):
    """coinrun-style with throwing stars clearing bomb hazards (+10 goal)."""

    def init(self, d, n):
        g = super().init(d, n)
        g.update(self._scalars(n, star_x=-1.0, star_col=0))
        return g

    def tick(self, g, action, d):
        dx, dy, sp = decode_action(action)
        star_x = torch.where(g["star_x"] >= 0, g["star_x"] + 1.0,
                             torch.where(sp == 1, g["x"] + 1.0, -1.0))
        scol = _col(star_x)
        hit = (star_x >= 0) & _at(g["hazards"], scol)
        cleared = g["hazards"].scatter(1, scol.long()[:, None], False)
        hazards = torch.where(hit[:, None], cleared, g["hazards"])
        star_x = torch.where(hit | (star_x > _N), -1.0, star_x)
        g2 = {**g, "hazards": hazards, "star_x": star_x}
        x, y, vy, col = self.physics(g2, dx, dy > 0)
        fell = y < -1.0
        on_hazard = _at(hazards, col) & (y <= _at(g["heights"], col).to(torch.float32) + 0.1)
        win = x >= _N - 1.5
        reward = torch.where(win, 10.0, 0.0)
        return {**g2, "x": x, "y": y, "vy": vy}, reward, fell | on_hazard | win


class JumperGame(_PlatformBase):
    """Open-world double-jump to the carrot (+10)."""

    def init_draws(self, sub):
        """The terrain's draws and ``goal_col`` ``[N]`` uniform in ``[_N //
        2, _N)``."""
        return {**_terrain_draws(sub), "goal_col": _N // 2 + rng.randint(sub, 3 * _N, _N // 2)}

    def init(self, d, n):
        heights, gaps, _ = _terrain(d, self.gap_p, 6)
        return {**self._scalars(n, x=0.0, y=3.0, vy=0.0, jumps=0),
                "heights": heights, "gaps": gaps,
                "hazards": torch.zeros(n, _N, dtype=torch.bool, device=self.device),
                "goal_col": d["goal_col"].to(torch.int32)}

    def tick(self, g, action, d):
        dx, dy, sp = decode_action(action)
        want_jump = (dy > 0) | (sp == 1)
        col = _col(g["x"])
        floor = torch.where(_at(g["gaps"], col), -2.0, _at(g["heights"], col).to(torch.float32))
        on_ground = g["y"] <= floor + 0.05
        jumps = torch.where(on_ground, 0, g["jumps"])
        do_jump = want_jump & (on_ground | (jumps < 2))
        x, y, vy, col = self.physics(g, dx, do_jump & on_ground)
        # Air double-jump.
        vy = torch.where(do_jump & ~on_ground, 1.2, vy)
        jumps = (jumps + do_jump.to(torch.int32)).to(torch.int32)
        fell = y < -1.0
        at_goal = (col == g["goal_col"]) & (y <= _at(g["heights"], col).to(torch.float32) + 0.3)
        reward = torch.where(at_goal, 10.0, 0.0)
        return {**g, "x": x, "y": y, "vy": vy, "jumps": jumps}, reward, fell | at_goal

    def render(self, g):
        cells, _, _, _ = self._ground(g)
        gr = torch.clamp(_N - 1 - _at(g["heights"], g["goal_col"]), 0, _N - 1)
        paint_cell(cells, gr, g["goal_col"], _COIN)
        return self._agent(cells, g)


class ClimberGame(_PlatformBase):
    """Climb platforms collecting stars (+1 each, +10 at the top)."""

    N_PLAT = 8
    # jnp.linspace(_N - 3, 1, N_PLAT).astype(int32)
    PLAT_ROWS = (13, 11, 9, 7, 6, 4, 2, 1)

    def init_draws(self, sub):
        """``plat_cols`` ``[N, 8]`` uniform in ``[0, _N - 3)``; ``stars``
        ``[N, 8]`` uniform in ``[0, 1)`` (a star where ``< 0.7``)."""
        return {"plat_cols": rng.randint(sub, 0, _N - 3, self.N_PLAT),
                "stars": rng.uniform(sub, self.N_PLAT, self.N_PLAT)}

    def init(self, d, n):
        rows = const(self.PLAT_ROWS, self.device, torch.int32)
        return {**self._scalars(n, x=1.0, y=1.0, vy=0.0),
                "plat_cols": d["plat_cols"].to(torch.int32),
                "plat_rows": rows.expand(n, self.N_PLAT).clone(),
                "stars": d["stars"] < 0.7}

    def _on(self, g, x):
        col = x.to(torch.int32)[:, None]
        return (col >= g["plat_cols"]) & (col <= g["plat_cols"] + 2)

    def tick(self, g, action, d):
        dx, dy, sp = decode_action(action)
        x = torch.clamp(g["x"] + 0.4 * dx.to(torch.float32), 0.0, _N - 1.0)
        plat_y = (_N - 1 - g["plat_rows"]).to(torch.float32)
        on = self._on(g, x)
        # Highest platform at or below the agent's feet in its column.
        below = on & (plat_y <= g["y"][:, None] + 0.05)
        floor = torch.where(below, plat_y, 0.0).max(1).values
        on_ground = g["y"] <= floor + 0.05
        jump = (dy > 0) | (sp == 1)
        vy = torch.where(jump & on_ground, 1.5, g["vy"] - 0.18)
        y = torch.maximum(g["y"] + vy, floor)
        vy = torch.where(y <= floor, 0.0, vy)
        # Star collection on the platform the agent stands in.
        got = on & (torch.abs(plat_y - y[:, None]) < 0.6) & g["stars"]
        stars = g["stars"] & ~got
        top = y >= _N - 2.5
        reward = got.sum(1).to(torch.float32) + torch.where(top, 10.0, 0.0)
        return {**g, "x": x, "y": y, "vy": vy, "stars": stars}, reward, top

    def render(self, g):
        n = g["x"].shape[0]
        cells = self._sky(n)
        ground, star = const(_GROUND, self.device), const(_STAR, self.device)
        env = torch.arange(n, device=self.device)
        for i in range(self.N_PLAT):
            r, c = g["plat_rows"][:, i], g["plat_cols"][:, i]
            for off in range(3):
                paint_cell(cells, r, torch.clamp(c + off, 0, _N - 1), ground)
            sr = torch.clamp(r - 1, 0, _N - 1)
            under = cells[env, sr.long(), (c + 1).long()]
            paint_cell(cells, sr, c + 1, torch.where(g["stars"][:, i, None], star, under))
        return self._agent(cells, g)


class LeaperGame(_PlatformBase):
    """Frogger: cross car lanes and log river to the top (+10)."""

    N_LANES = 6

    @property
    def hard(self):
        return self.mode in ("hard", "extreme")

    def init_draws(self, sub):
        """``cars`` ``[N, 6]`` uniform in ``[0, _N)``."""
        return {"cars": _N * rng.uniform(sub, 0, self.N_LANES)}

    def init(self, d, n):
        even = torch.arange(self.N_LANES, device=self.device) % 2 == 0
        speeds = torch.where(even, 0.3, -0.3) * (1.5 if self.hard else 1.0)
        return {**self._scalars(n, x=_N / 2, row=0), "cars": d["cars"],
                "speeds": speeds.expand(n, self.N_LANES).clone()}

    def tick(self, g, action, d):
        dx, dy, _ = decode_action(action)
        x = torch.clamp(g["x"] + dx.to(torch.float32), 0.0, _N - 1.0)
        row = torch.clamp(g["row"] + dy, 0, self.N_LANES + 1).to(torch.int32)
        cars = mod(g["cars"] + g["speeds"], _N)
        in_lane = (row >= 1) & (row <= self.N_LANES)
        lane = torch.clamp(row - 1, 0, self.N_LANES - 1)
        hit = in_lane & (torch.abs(_at(cars, lane) - x) < 1.6)
        win = row > self.N_LANES
        reward = torch.where(win, 10.0, 0.0)
        return {**g, "x": x, "row": row, "cars": cars}, reward, hit | win

    def render(self, g):
        n = g["x"].shape[0]
        cells = self._sky(n, _GRASS)
        for i in range(self.N_LANES):
            r = _N - 3 - 2 * i
            cells[:, r, :] = const(_ROAD, self.device)
            c = torch.clamp(g["cars"][:, i].to(torch.int32), 0, _N - 1)
            paint_cell(cells, torch.full_like(c, r), c, _HAZARD)
        ar = torch.clamp(_N - 2 - 2 * g["row"], 0, _N - 1)
        paint_cell(cells, ar, _col(g["x"]), _AGENT)
        return render_grid(cells)
