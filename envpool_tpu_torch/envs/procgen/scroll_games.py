"""Scroller-engine procgen games, batched over ``[N]`` envs: bigfish,
starpilot, fruitbot, dodgeball, bossfight, caveflyer, plunder.

Counterpart of ``envpool_tpu/envs/procgen/scroll_games.py``: a continuous
``[0, 64]^2`` playfield, per-step entity kinematics over ``_NE`` fixed
slots with validity masks (``[N, _NE]``), schematic sprites.  Every spawn
draw has a slot of its own in the port's streams; the draws are handed
over as the values the game uses (positions, speeds), so a test can hand
in JAX's.
"""

from __future__ import annotations

import torch

from ...core import rng
from ...ops.batched import const, first_argmin, mod
from .core import RES, Canvas, decode_action

_NE = 10  # entity slots


def _norm(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` of 2-vectors given by their components."""
    return torch.sqrt(dx * dx + dy * dy)


def _edge_draws(sub, lo: float, hi: float) -> dict:
    """The draws of ``_spawn_edge``: ``y`` in ``[4, RES - 4)``, ``vx`` in
    ``(-hi, -lo]``, ``size`` in ``[1, 4)``, and the spawn draw ``spawn`` in
    ``[0, 1)``, each ``[N]``."""
    return {
        "spawn": rng.uniform(sub, 0),
        "y": 4.0 + (RES - 8.0) * rng.uniform(sub, 1),
        "vx": -(lo + (hi - lo) * rng.uniform(sub, 2)),
        "size": 1.0 + 3.0 * rng.uniform(sub, 3),
    }


def _spawn(ents, alive, spawn, new):
    """Put ``new`` (``[N, F]``) into the first free slot where ``spawn``
    and a slot is free (``jnp.argmin(alive)``)."""
    slot = first_argmin(alive)
    at = torch.arange(_NE, device=alive.device) == slot[:, None]
    at = at & (spawn & ~alive.all(1))[:, None]
    return torch.where(at[..., None], new[:, None, :], ents), alive | at


class _ScrollBase:
    def __init__(self, size: int, mode: str, device: torch.device):
        self.mode = mode
        self.device = device
        self.hard = mode in ("hard", "extreme")
        self.spawn_p = 0.15 if self.hard else 0.08

    def init_draws(self, sub):
        del sub
        return {}

    def tick_draws(self, sub):
        del sub
        return {}

    def _full(self, n, value, dtype=torch.float32):
        return torch.full((n,), value, dtype=dtype, device=self.device)

    def _vec(self, n, *values):
        return const(tuple(values), self.device).expand(n, len(values)).clone()

    def _zeros(self, *shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _move_player(self, p, dx, dy, speed=1.5):
        step = torch.stack([dx.to(torch.float32), dy.to(torch.float32)], 1) * speed
        return torch.clamp(p + step, 2.0, RES - 2.0)


class BigfishGame(_ScrollBase):
    """Eat smaller fish (+1); eaten by bigger ones; grow; +10 when
    biggest."""

    def init(self, d, n):
        return {
            "p": self._vec(n, 16.0, 32.0),
            "size": self._full(n, 1.5),
            "ents": self._zeros(n, _NE, 5),
            "alive": self._zeros(n, _NE, dtype=torch.bool),
            "t": self._full(n, 0, torch.int32),
        }

    def tick_draws(self, sub):
        return _edge_draws(sub, 0.3, 0.9)

    def tick(self, g, action, d):
        dx, dy, _ = decode_action(action)
        p = self._move_player(g["p"], dx, dy)
        ents = g["ents"].clone()
        ents[:, :, 0] += g["ents"][:, :, 2]
        alive = g["alive"] & (ents[:, :, 0] > -4.0)
        spawn = d["spawn"] < self.spawn_p
        new = torch.stack([torch.full_like(d["y"], RES - 2.0), d["y"], d["vx"],
                           torch.zeros_like(d["y"]), d["size"]], 1)
        ents, alive = _spawn(ents, alive, spawn, new)
        dist = _norm(ents[:, :, 0] - p[:, 0:1], ents[:, :, 1] - p[:, 1:2])
        size = g["size"][:, None]
        touch = alive & (dist < (size + ents[:, :, 4]))
        smaller = ents[:, :, 4] < size
        eat = touch & smaller
        eaten_by = (touch & ~smaller).any(1)
        n_eat = eat.sum(1).to(torch.float32)
        size = g["size"] + 0.3 * n_eat
        alive = alive & ~eat
        win = size >= 8.0
        reward = n_eat + torch.where(win, 10.0, 0.0)
        done = eaten_by | win
        return ({"p": p, "size": size, "ents": ents, "alive": alive, "t": g["t"] + 1},
                reward, done)

    def render(self, g):
        ents = g["ents"]
        img = Canvas(ents.shape[0], (30.0, 70.0, 140.0), self.device)
        small = const((120.0, 220.0, 120.0), self.device)
        big = const((220.0, 80.0, 80.0), self.device)
        for i in range(_NE):
            rgb = torch.where((ents[:, i, 4] < g["size"])[:, None], small, big)
            img.disc(ents[:, i, 0], ents[:, i, 1], ents[:, i, 4], rgb, cond=g["alive"][:, i])
        img.disc(g["p"][:, 0], g["p"][:, 1], g["size"], (240.0, 200.0, 60.0))
        return img.frame()


def _bullet_off(n, ref):
    return const((-1.0, 0.0), ref.device).expand(n, 2)


class StarpilotGame(_ScrollBase):
    """Side-scrolling shooter: fire (+1 per kill), die on contact."""

    def init(self, d, n):
        return {
            "p": self._vec(n, 10.0, 32.0),
            "ents": self._zeros(n, _NE, 5),
            "alive": self._zeros(n, _NE, dtype=torch.bool),
            "bullet": self._vec(n, -1.0, 0.0),
            "t": self._full(n, 0, torch.int32),
        }

    def tick_draws(self, sub):
        return _edge_draws(sub, 0.6, 1.4)

    def tick(self, g, action, d):
        dx, dy, sp = decode_action(action)
        p = self._move_player(g["p"], dx, dy)
        n = p.shape[0]
        fire = (sp == 1)[:, None]
        b = g["bullet"]
        flying = (b[:, 0] >= 0)[:, None]
        shot = torch.stack([p[:, 0] + 2, p[:, 1]], 1)
        bullet = torch.where(flying, b + const((4.0, 0.0), b.device), torch.where(fire, shot, b))
        off = _bullet_off(n, b)
        bullet = torch.where((bullet[:, 0] > RES)[:, None], off, bullet)
        ents = g["ents"].clone()
        ents[:, :, 0] += g["ents"][:, :, 2]
        alive = g["alive"] & (ents[:, :, 0] > -4.0)
        new = torch.stack([torch.full_like(d["y"], RES - 2.0), d["y"], d["vx"],
                           torch.zeros_like(d["y"]), d["size"]], 1)
        ents, alive = _spawn(ents, alive, d["spawn"] < self.spawn_p, new)
        db = _norm(ents[:, :, 0] - bullet[:, 0:1], ents[:, :, 1] - bullet[:, 1:2])
        hit = alive & (db < ents[:, :, 4] + 1.5) & (bullet[:, 0:1] >= 0)
        kills = hit.sum(1)
        alive = alive & ~hit
        bullet = torch.where(hit.any(1)[:, None], off, bullet)
        dp = _norm(ents[:, :, 0] - p[:, 0:1], ents[:, :, 1] - p[:, 1:2])
        dead = (alive & (dp < ents[:, :, 4] + 1.5)).any(1)
        return ({"p": p, "ents": ents, "alive": alive, "bullet": bullet, "t": g["t"] + 1},
                kills.to(torch.float32), dead)

    def render(self, g):
        ents = g["ents"]
        img = Canvas(ents.shape[0], (15.0, 15.0, 30.0), self.device)
        for i in range(_NE):
            img.disc(ents[:, i, 0], ents[:, i, 1], ents[:, i, 4], (200.0, 80.0, 200.0),
                     cond=g["alive"][:, i])
        b = g["bullet"]
        img.disc(b[:, 0], b[:, 1], 1.2, (255.0, 255.0, 160.0), cond=b[:, 0] >= 0)
        img.disc(g["p"][:, 0], g["p"][:, 1], 2.2, (80.0, 180.0, 255.0))
        return img.frame()


class FruitbotGame(_ScrollBase):
    """Catch fruit (+1), avoid junk (-4); reach the end (+10)."""

    LENGTH = 400

    def init(self, d, n):
        return {
            "p": self._vec(n, 32.0, 6.0),
            "ents": self._zeros(n, _NE, 5),  # x y vy kind size
            "alive": self._zeros(n, _NE, dtype=torch.bool),
            "t": self._full(n, 0, torch.int32),
        }

    def tick_draws(self, sub):
        """``spawn`` and ``kind`` in ``[0, 1)`` (fruit where ``kind <
        0.5``), ``x`` in ``[4, RES - 4)``."""
        return {"spawn": rng.uniform(sub, 0), "x": 4.0 + (RES - 8.0) * rng.uniform(sub, 1),
                "kind": rng.uniform(sub, 2)}

    def tick(self, g, action, d):
        dx, _, _ = decode_action(action)
        dxf = dx.to(torch.float32)
        step = torch.stack([dxf * 2.0, torch.zeros_like(dxf)], 1)
        p = torch.clamp(g["p"] + step, 2.0, RES - 2.0)
        ents = g["ents"].clone()
        ents[:, :, 1] += -1.2
        alive = g["alive"] & (ents[:, :, 1] > 0.0)
        kind = (d["kind"] < 0.5).to(torch.float32)
        x = d["x"]
        new = torch.stack([x, torch.full_like(x, RES - 2.0), torch.zeros_like(x), kind,
                           torch.full_like(x, 2.0)], 1)
        ents, alive = _spawn(ents, alive, d["spawn"] < self.spawn_p * 2, new)
        dist = _norm(ents[:, :, 0] - p[:, 0:1], ents[:, :, 1] - p[:, 1:2])
        touch = alive & (dist < 3.5)
        fruit = touch & (ents[:, :, 3] > 0.5)
        junk = touch & (ents[:, :, 3] <= 0.5)
        alive = alive & ~touch
        reward = fruit.sum(1).to(torch.float32) - 4.0 * junk.sum(1)
        t = g["t"] + 1
        win = t >= self.LENGTH
        reward = reward + torch.where(win, 10.0, 0.0)
        return {"p": p, "ents": ents, "alive": alive, "t": t}, reward, win

    def render(self, g):
        ents = g["ents"]
        img = Canvas(ents.shape[0], (40.0, 45.0, 40.0), self.device)
        fruit = const((230.0, 120.0, 60.0), self.device)
        junk = const((100.0, 100.0, 110.0), self.device)
        for i in range(_NE):
            rgb = torch.where((ents[:, i, 3] > 0.5)[:, None], fruit, junk)
            img.disc(ents[:, i, 0], ents[:, i, 1], 2.0, rgb, cond=g["alive"][:, i])
        img.disc(g["p"][:, 0], g["p"][:, 1], 2.5, (120.0, 220.0, 120.0))
        return img.frame()


def _field_draws(sub, ranges) -> torch.Tensor:
    """``[N, _NE, len(ranges)]``: field ``j`` of every slot uniform in
    ``ranges[j]``, each from slots of its own."""
    cols = [lo + (hi - lo) * rng.uniform(sub, j * _NE, _NE) for j, (lo, hi) in enumerate(ranges)]
    return torch.stack(cols, 2)


class DodgeballGame(_ScrollBase):
    """Hit all enemies with balls (+1 each, +10 clear), don't get hit."""

    def init_draws(self, sub):
        """``ents`` ``[N, _NE, 4]``: x in ``[20, RES - 4)``, y in ``[4, RES
        - 4)``, vx and vy in ``[-0.5, 0.5)``."""
        return {"ents": _field_draws(sub, ((20.0, RES - 4.0), (4.0, RES - 4.0),
                                           (-0.5, 0.5), (-0.5, 0.5)))}

    def init(self, d, n):
        e = d["ents"]
        k = 4 if not self.hard else 7
        return {
            "p": self._vec(n, 6.0, 32.0),
            "ents": torch.cat([e, torch.full_like(e[..., :1], 2.0)], 2),
            "alive": (torch.arange(_NE, device=self.device) < k).expand(n, _NE).clone(),
            "ball": self._vec(n, -1.0, 0.0, 0.0, 0.0),
            "t": self._full(n, 0, torch.int32),
        }

    def tick(self, g, action, d):
        dx, dy, sp = decode_action(action)
        p = self._move_player(g["p"], dx, dy)
        b = g["ball"]
        fire = (sp == 1) & (b[:, 0] < 0)
        ax = torch.where(dx == 0, 1.0, dx.to(torch.float32))
        ay = dy.to(torch.float32)
        norm = _norm(ax, ay) + 1e-6
        aim = torch.stack([ax / norm, ay / norm], 1)
        moved = torch.cat([b[:, :2] + b[:, 2:], b[:, 2:]], 1)
        ball = torch.where(fire[:, None], torch.cat([p, aim * 3.0], 1), moved)
        out = (ball[:, 0] < 0) | (ball[:, 0] > RES) | (ball[:, 1] < 0) | (ball[:, 1] > RES)
        ball = torch.where((out & ~fire)[:, None], const((-1.0, 0.0, 0.0, 0.0), b.device), ball)
        # Enemies bounce around.
        e = g["ents"]
        xy = e[:, :, :2] + e[:, :, 2:4]
        bounce_x = (xy[:, :, 0] < 2) | (xy[:, :, 0] > RES - 2)
        bounce_y = (xy[:, :, 1] < 2) | (xy[:, :, 1] > RES - 2)
        vx = e[:, :, 2] * torch.where(bounce_x, -1.0, 1.0)
        vy = e[:, :, 3] * torch.where(bounce_y, -1.0, 1.0)
        ents = torch.cat([xy, vx[..., None], vy[..., None], e[:, :, 4:]], 2)
        db = _norm(xy[:, :, 0] - ball[:, 0:1], xy[:, :, 1] - ball[:, 1:2])
        hit = g["alive"] & (db < 3.0) & (ball[:, 0:1] >= 0)
        alive = g["alive"] & ~hit
        dp = _norm(xy[:, :, 0] - p[:, 0:1], xy[:, :, 1] - p[:, 1:2])
        tagged = (alive & (dp < 3.0)).any(1)
        cleared = ~alive.any(1)
        reward = hit.sum(1).to(torch.float32) + torch.where(
            cleared & g["alive"].any(1), 10.0, 0.0)
        return ({"p": p, "ents": ents, "alive": alive, "ball": ball, "t": g["t"] + 1},
                reward, tagged | cleared)

    def render(self, g):
        ents, ball = g["ents"], g["ball"]
        img = Canvas(ents.shape[0], (50.0, 50.0, 60.0), self.device)
        for i in range(_NE):
            img.disc(ents[:, i, 0], ents[:, i, 1], 2.0, (220.0, 90.0, 90.0),
                     cond=g["alive"][:, i])
        img.disc(ball[:, 0], ball[:, 1], 1.3, (250.0, 250.0, 250.0), cond=ball[:, 0] >= 0)
        img.disc(g["p"][:, 0], g["p"][:, 1], 2.2, (90.0, 160.0, 250.0))
        return img.frame()


class BossfightGame(_ScrollBase):
    """Damage the boss between its attack barrages (+1 per hit round,
    +10 on kill)."""

    def init(self, d, n):
        return {
            "p": self._vec(n, 32.0, 8.0),
            "boss_x": self._full(n, 32.0),
            "boss_hp": self._full(n, 9 if self.hard else 5, torch.int32),
            "shots": self._zeros(n, _NE, 4),
            "shot_live": self._zeros(n, _NE, dtype=torch.bool),
            "bullet": self._vec(n, -1.0, 0.0),
            "t": self._full(n, 0, torch.int32),
        }

    def tick_draws(self, sub):
        """``boss_dx`` in ``[-1, 1)``, ``spawn`` in ``[0, 1)``."""
        return {"boss_dx": -1.0 + 2.0 * rng.uniform(sub, 0), "spawn": rng.uniform(sub, 1)}

    def tick(self, g, action, d):
        dx, dy, sp = decode_action(action)
        p = self._move_player(g["p"], dx, dy)
        n = p.shape[0]
        boss_x = torch.clamp(g["boss_x"] + d["boss_dx"], 8.0, RES - 8.0)
        # Player bullet (up).
        b = g["bullet"]
        fire = ((sp == 1) & (b[:, 0] < 0))[:, None]
        up = const((0.0, 3.0), b.device) * (b[:, 0:1] >= 0)
        bullet = torch.where(fire, torch.stack([p[:, 0], p[:, 1] + 3], 1), b + up)
        off = _bullet_off(n, b)
        bullet = torch.where((bullet[:, 1] > RES)[:, None], off, bullet)
        hit_boss = ((bullet[:, 0] >= 0) & (torch.abs(bullet[:, 0] - boss_x) < 5.0)
                    & (bullet[:, 1] > RES - 12.0))
        boss_hp = (g["boss_hp"] - hit_boss.to(torch.int32)).to(torch.int32)
        bullet = torch.where(hit_boss[:, None], off, bullet)
        # Boss barrage.
        s = g["shots"]
        shots = torch.cat([s[:, :, :2] + s[:, :, 2:], s[:, :, 2:]], 2)
        live = g["shot_live"] & (shots[:, :, 1] > 0)
        spawn = d["spawn"] < (0.25 if self.hard else 0.15)
        ax, ay = p[:, 0] - boss_x, p[:, 1] - (RES - 6.0)
        norm = _norm(ax, ay) + 1e-6
        new = torch.stack([boss_x, torch.full_like(boss_x, RES - 6.0),
                           ax / norm * 1.6, ay / norm * 1.6], 1)
        shots, live = _spawn(shots, live, spawn, new)
        dp = _norm(shots[:, :, 0] - p[:, 0:1], shots[:, :, 1] - p[:, 1:2])
        dead = (live & (dp < 2.5)).any(1)
        win = boss_hp <= 0
        reward = hit_boss.to(torch.float32) + torch.where(win, 10.0, 0.0)
        return ({"p": p, "boss_x": boss_x, "boss_hp": boss_hp, "shots": shots,
                 "shot_live": live, "bullet": bullet, "t": g["t"] + 1},
                reward, dead | win)

    def render(self, g):
        shots, b = g["shots"], g["bullet"]
        img = Canvas(shots.shape[0], (20.0, 18.0, 35.0), self.device)
        img.disc(g["boss_x"], torch.full_like(g["boss_x"], RES - 6.0), 5.0,
                 (200.0, 60.0, 200.0))
        for i in range(_NE):
            img.disc(shots[:, i, 0], shots[:, i, 1], 1.4, (255.0, 120.0, 60.0),
                     cond=g["shot_live"][:, i])
        img.disc(b[:, 0], b[:, 1], 1.2, (160.0, 255.0, 160.0), cond=b[:, 0] >= 0)
        img.disc(g["p"][:, 0], g["p"][:, 1], 2.2, (90.0, 170.0, 255.0))
        return img.frame()


class CaveflyerGame(_ScrollBase):
    """Asteroids-style cave flight to the exit (+10); rocks kill."""

    def init_draws(self, sub):
        """``ents`` ``[N, _NE, 5]``: x in ``[16, RES - 4)``, y in ``[4, RES
        - 4)``, vx and vy in ``[-0.4, 0.4)``, size in ``[2, 4)``."""
        return {"ents": _field_draws(sub, ((16.0, RES - 4.0), (4.0, RES - 4.0),
                                           (-0.4, 0.4), (-0.4, 0.4), (2.0, 4.0)))}

    def init(self, d, n):
        e = d["ents"]
        return {
            "p": self._vec(n, 5.0, 32.0),
            "v": self._zeros(n, 2),
            "ents": e,
            "alive": torch.ones(n, _NE, dtype=torch.bool, device=self.device),
            "t": self._full(n, 0, torch.int32),
        }

    def tick(self, g, action, d):
        dx, dy, _ = decode_action(action)
        thrust = 0.25 * torch.stack([dx.to(torch.float32), dy.to(torch.float32)], 1)
        v = torch.clamp(g["v"] + thrust, -2.0, 2.0) * 0.97
        p = torch.clamp(g["p"] + v, 2.0, RES - 2.0)
        e = g["ents"]
        xy = mod(e[:, :, :2] + e[:, :, 2:4], RES)
        ents = torch.cat([xy, e[:, :, 2:]], 2)
        dist = _norm(xy[:, :, 0] - p[:, 0:1], xy[:, :, 1] - p[:, 1:2])
        crash = (g["alive"] & (dist < ents[:, :, 4] + 1.5)).any(1)
        at_exit = p[:, 0] > RES - 4.0
        reward = torch.where(at_exit, 10.0, 0.0)
        return ({"p": p, "v": v, "ents": ents, "alive": g["alive"], "t": g["t"] + 1},
                reward, crash | at_exit)

    def render(self, g):
        ents = g["ents"]
        img = Canvas(ents.shape[0], (25.0, 20.0, 20.0), self.device)
        img.img[:, :, RES - 3:] = const((240.0, 210.0, 60.0), ents.device)  # the exit band
        for i in range(_NE):
            img.disc(ents[:, i, 0], ents[:, i, 1], ents[:, i, 4], (110.0, 100.0, 90.0),
                     cond=g["alive"][:, i])
        img.disc(g["p"][:, 0], g["p"][:, 1], 2.0, (120.0, 220.0, 255.0))
        return img.frame()


class PlunderGame(_ScrollBase):
    """Sink enemy ships (+1), avoid friendly ones (-1, timer penalty)."""

    def init(self, d, n):
        return {
            "p": self._vec(n, 32.0, 5.0),
            "ents": self._zeros(n, _NE, 5),  # x y vx kind size
            "alive": self._zeros(n, _NE, dtype=torch.bool),
            "bullet": self._vec(n, -1.0, 0.0),
            "timer": self._full(n, 1.0),
            "t": self._full(n, 0, torch.int32),
        }

    def tick_draws(self, sub):
        """``spawn`` and ``kind`` in ``[0, 1)`` (an enemy where ``kind <
        0.5``), ``lane`` in ``[24, RES - 6)``."""
        return {"spawn": rng.uniform(sub, 0), "lane": 24.0 + (RES - 30.0) * rng.uniform(sub, 1),
                "kind": rng.uniform(sub, 2)}

    def tick(self, g, action, d):
        dx, _, sp = decode_action(action)
        n = dx.shape[0]
        dxf = dx.to(torch.float32)
        step = torch.stack([dxf * 1.5, torch.zeros_like(dxf)], 1)
        p = torch.clamp(g["p"] + step, 2.0, RES - 2.0)
        b = g["bullet"]
        fire = ((sp == 1) & (b[:, 0] < 0))[:, None]
        up = const((0.0, 2.5), b.device) * (b[:, 0:1] >= 0)
        bullet = torch.where(fire, torch.stack([p[:, 0], p[:, 1] + 2], 1), b + up)
        off = _bullet_off(n, b)
        bullet = torch.where((bullet[:, 1] > RES)[:, None], off, bullet)
        ents = g["ents"].clone()
        ents[:, :, 0] += g["ents"][:, :, 2]
        alive = g["alive"] & (ents[:, :, 0] > -4.0) & (ents[:, :, 0] < RES + 4.0)
        kind = (d["kind"] < 0.5).to(torch.float32)
        lane = d["lane"]
        new = torch.stack([torch.full_like(lane, RES - 2.0), lane, torch.full_like(lane, -0.8),
                           kind, torch.full_like(lane, 2.5)], 1)
        ents, alive = _spawn(ents, alive, d["spawn"] < self.spawn_p * 1.5, new)
        db = (torch.abs(ents[:, :, 0] - bullet[:, 0:1])
              + torch.abs(ents[:, :, 1] - bullet[:, 1:2]))
        hit = alive & (db < 4.0) & (bullet[:, 0:1] >= 0)
        enemy_hit = hit & (ents[:, :, 3] > 0.5)
        friend_hit = hit & (ents[:, :, 3] <= 0.5)
        alive = alive & ~hit
        bullet = torch.where(hit.any(1)[:, None], off, bullet)
        timer = g["timer"] - 0.001 - 0.05 * friend_hit.sum(1)
        reward = enemy_hit.sum(1).to(torch.float32) - friend_hit.sum(1)
        return ({"p": p, "ents": ents, "alive": alive, "bullet": bullet, "timer": timer,
                 "t": g["t"] + 1},
                reward, timer <= 0.0)

    def render(self, g):
        ents, b = g["ents"], g["bullet"]
        img = Canvas(ents.shape[0], (30.0, 60.0, 110.0), self.device)
        enemy = const((200.0, 70.0, 70.0), self.device)
        friend = const((210.0, 210.0, 210.0), self.device)
        for i in range(_NE):
            rgb = torch.where((ents[:, i, 3] > 0.5)[:, None], enemy, friend)
            img.disc(ents[:, i, 0], ents[:, i, 1], 2.5, rgb, cond=g["alive"][:, i])
        img.disc(b[:, 0], b[:, 1], 1.2, (255.0, 240.0, 150.0), cond=b[:, 0] >= 0)
        img.disc(g["p"][:, 0], g["p"][:, 1], 2.5, (240.0, 200.0, 80.0))
        return img.frame()
