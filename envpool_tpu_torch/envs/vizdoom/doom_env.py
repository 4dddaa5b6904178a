"""Doom-like scenario env, batched over ``[N]`` envs.

Counterpart of ``envpool_tpu/envs/vizdoom/doom_env.py`` (reference surface
``envpool/vizdoom/vizdoom_env.h``): obs ``[stack_num * channels,
img_height, img_width]`` uint8 with frame stacking (filled on reset); float
button actions, or one discrete id over the combined action set
(``use_combined_action``); the 16 game-variable info keys; the
reference's shaped variable-delta reward.  The world is the JAX package's
grid-arena surrogate: raycast rendering, hitscan and projectile combat,
chasing monsters, pickups, acid floors, fireball volleys.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv
from ...core.specs import ArraySpec
from ...ops.image import resize_area
from ...ops.batched import const, first_argmin, full_fp32, mod
from . import buttons as B
from .buttons import build_action_set
from .raycast import (
    H, W, SPR_AMMO, SPR_ARMOR, SPR_FIREBALL, SPR_MEDKIT, SPR_MONSTER,
    SPR_POISON, SPR_VEST, extract_cells, render_frame,
)
from .scenarios import SCENARIOS, Scenario

# Game-variable vector layout (reference info_index_, vizdoom_env.h:155).
GV_NAMES = (
    "AMMO2", "AMMO3", "AMMO4", "AMMO5", "AMMO6", "AMMO7",
    "ARMOR", "DAMAGECOUNT", "DEATHCOUNT", "FRAGCOUNT", "HEALTH",
    "HITCOUNT", "KILLCOUNT", "SELECTED_WEAPON", "SELECTED_WEAPON_AMMO",
    "USER2",
)
# Default reward_config weights (vizdoom_env.h:70-90), mapped onto the
# vector above.  SELECTED_WEAPON[_AMMO]/USER2 carry no weight.
_POS = (0.0002, 0.001, 0.001, 0.001, 0.002, 0.002,
        0.005, 0.003, -0.75, 1.0, 0.005, 0.01, 1.0, 0.0, 0.0, 0.0)
_NEG = (-0.0001, -0.0005, -0.0005, -0.0005, -0.001, -0.001,
        -0.001, -0.003, 0.75, -1.5, -0.003, -0.01, 0.0, 0.0, 0.0, 0.0)
# selected_weapon_reward_config (vizdoom_env.h:91-99), slots 0..7.
_WEAPON_REWARD = (0.0002, 0.0002, 0.0002, 0.001, 0.001, 0.001, 0.002, 0.002, 0.0, 0.0)

_TURN = 0.20       # rad per 4-tic step
_MOVE = 0.55       # cells per 4-tic step
_RADIUS = 0.3      # player collision radius
_NR = 2            # player projectile slots
_NF = 4            # incoming fireball slots

_W2SLOT = {
    B.SELECT_WEAPON1: 1, B.SELECT_WEAPON2: 2, B.SELECT_WEAPON3: 3,
    B.SELECT_WEAPON4: 4, B.SELECT_WEAPON5: 5, B.SELECT_WEAPON6: 6,
    B.SELECT_WEAPON7: 7,
}
_ITEM_KIND = {"medkit": SPR_MEDKIT, "armor": SPR_ARMOR, "ammo": SPR_AMMO, "poison": SPR_POISON}


def shaped_reward(gvs, last_gvs, sel_count, weapon_duration: int):
    """The reference's delta reward (vizdoom_env.h:408-446), ``[N]`` from
    ``[N, 16]`` game variables."""
    dev = gvs.device
    delta = gvs - last_gvs
    cap = torch.full_like(delta, torch.inf)
    cap[:, 7], cap[:, 11] = 200.0, 5.0      # DAMAGECOUNT, HITCOUNT caps
    delta = torch.minimum(delta, cap)
    r = torch.where(delta >= 0, delta * const(_POS, dev), -delta * const(_NEG, dev)).sum(1)
    sel_w = gvs[:, 13].to(torch.int32)
    bonus = const(_WEAPON_REWARD, dev)[torch.clamp(sel_w, 0, 9).long()]
    give = (sel_w >= 0) & (sel_count >= weapon_duration) & (gvs[:, 14] > 0)
    return r + torch.where(give, bonus, 0.0)


def _slot_mask(slot, k):
    return torch.arange(k, device=slot.device) == slot[:, None]


class DoomEnv(TorchEnv):
    DEFAULT_CONFIG = {
        "scenario": "basic",
        "img_height": 84,
        "img_width": 84,
        "stack_num": 4,
        "frame_skip": 4,
        "episodic_life": False,
        "force_speed": False,
        "use_combined_action": False,
        "use_inter_area_resize": True,
        "weapon_duration": 5,
        # wad_path: when set, the arena layout is parsed from the scenario
        # WAD's LINEDEFS (wad.py) instead of the hand-authored grid.  The
        # other engine-path keys are accepted for reference-config
        # compatibility and unused.
        "cfg_path": "",
        "wad_path": "",
        "vzd_path": "",
        "iwad_path": "",
        "game_args": "",
        "map_id": "map01",
        "lmp_save_dir": "",
    }

    def __init__(self, config):
        super().__init__(config)
        sc: Scenario = SCENARIOS[str(config["scenario"])]
        wad = str(config["wad_path"])
        if wad:
            from .wad import wad_to_grid

            grid = wad_to_grid(wad, g=sc.grid.shape[0],
                               map_name=str(config["map_id"]).upper() or None)
            sc = dataclasses.replace(sc, grid=grid)
        self.sc = sc
        dev = self.device
        self.g_size = sc.grid.shape[0]
        self.walls = torch.as_tensor(sc.grid, device=dev)
        self.free_flat = (self.walls == 0).reshape(-1)
        self.wall_cells = tuple(torch.as_tensor(c, device=dev) for c in extract_cells(sc.grid))
        self.buttons = list(sc.buttons)
        self.action_set = torch.as_tensor(
            build_action_set(self.buttons, bool(config["force_speed"])),
            dtype=torch.float32, device=dev)
        self.combined = bool(config["use_combined_action"])
        self.nm = max(sc.n_monsters, 1)
        self.ni = max(sc.n_items, 1)
        kinds = sc.item_kinds or ("medkit",)
        self.item_kinds = [_ITEM_KIND[kinds[i % len(kinds)]] for i in range(self.ni)]
        self.item_type = torch.as_tensor(self.item_kinds, dtype=torch.int32, device=dev)
        self.spr_type = ([SPR_MONSTER] * self.nm + self.item_kinds
                         + [SPR_FIREBALL] * (_NR + _NF) + [SPR_VEST])
        # Free cells for random spawns, (x, y) cell centres.
        free = np.argwhere(sc.grid == 0)
        self.free_rows = (float(free[:, 0].min()), float(free[:, 0].max()))
        self.free_cols = (float(free[:, 1].min()), float(free[:, 1].max()))
        self.free_cells = torch.as_tensor(free[:, ::-1].astype(np.float32) + 0.5, device=dev)
        self.skip = float(config["frame_skip"]) / 4.0

    # -- specs ----------------------------------------------------------

    @property
    def _hw(self):
        return int(self.config["img_height"]), int(self.config["img_width"])

    @property
    def _stack(self):
        return int(self.config["stack_num"])

    def state_spec(self):
        h, w = self._hw
        spec = {"obs": ArraySpec(np.uint8, (self._stack * self.sc.channels, h, w), 0, 255)}
        for name in GV_NAMES:
            spec[f"info:{name}"] = ArraySpec(np.float32, ())
        return spec

    def action_spec(self):
        if self.combined:
            n = self.action_set.shape[0]
            return {"action": ArraySpec(np.int32, (), 0, n - 1, is_discrete=True)}
        return {"action": ArraySpec(np.float32, (len(self.buttons),), 0.0, 1.0)}

    # -- draws ----------------------------------------------------------

    def reset_draws(self, sub):
        """``spawn_cell`` ``[N]`` and ``spawn_ang`` ``[N]`` in ``[0, 2 pi)``
        (random-spawn scenarios), ``monster_u`` ``[N, nm]`` in ``[0, 1)``
        (the east and north spawn bands) and ``monster_cell`` ``[N, nm]``
        (the ring), ``item_cell`` ``[N, ni]``: free-cell indices."""
        nm, ni, nf = self.nm, self.ni, self.free_cells.shape[0]
        return {
            "spawn_cell": rng.randint(sub, 0, nf),
            "spawn_ang": (2 * math.pi) * rng.uniform(sub, 1),
            "monster_u": rng.uniform(sub, 2, nm),
            "monster_cell": rng.randint(sub, 2 + nm, nf, nm),
            "item_cell": rng.randint(sub, 2 + 2 * nm, nf, ni),
        }

    def step_draws(self, sub):
        """``respawn_u`` / ``respawn_cell`` ``[N, nm]`` (monster respawns, as
        a reset's), ``fb_dx`` ``[N]`` in ``[-1.5, 1.5)`` (a fireball's launch
        offset), ``item_cell`` ``[N, ni]`` (item respawns)."""
        nm, ni, nf = self.nm, self.ni, self.free_cells.shape[0]
        return {
            "respawn_u": rng.uniform(sub, 0, nm),
            "respawn_cell": rng.randint(sub, nm, nf, nm),
            "fb_dx": -1.5 + 3.0 * rng.uniform(sub, 2 * nm),
            "item_cell": rng.randint(sub, 2 * nm + 1, nf, ni),
        }

    # -- helpers --------------------------------------------------------

    def _press(self, b, bid):
        """Pressed amount ``[N]`` of button ``bid`` from ``[N, nb]`` ``b``."""
        if bid in self.buttons:
            return b[:, self.buttons.index(bid)]
        return torch.zeros_like(b[:, 0])

    def _cell_free(self, x, y):
        g = self.g_size
        ix = torch.clamp(x.to(torch.int32), 0, g - 1)
        iy = torch.clamp(y.to(torch.int32), 0, g - 1)
        return self.free_flat[(iy * g + ix).long()]

    def _pos_free(self, x, y, r=_RADIUS):
        ok = None
        for sx in (-r, r):
            for sy in (-r, r):
                free = self._cell_free(x + sx, y + sy)
                ok = free if ok is None else ok & free
        return ok

    def _los(self, x0, y0, x1, y1):
        """Coarse line-of-sight from ``[N]`` (x0, y0) to ``[N, M]`` points:
        16 samples along each segment."""
        t = torch.arange(1, 16, dtype=x0.dtype, device=x0.device) / 16.0
        xs = x0[:, None, None] + (x1 - x0[:, None])[..., None] * t
        ys = y0[:, None, None] + (y1 - y0[:, None])[..., None] * t
        return self._cell_free(xs, ys).all(-1)

    def _monster_spawn(self, u, cell):
        """``[N, n, 2]`` spawn points per the scenario's band (east wall,
        north wall, corridor pairs, or random free cells)."""
        sc = self.sc
        n = u.shape[1]
        (rlo, rhi), (clo, chi) = self.free_rows, self.free_cols
        if sc.monster_wall == "east":
            x = torch.full_like(u, chi + 0.5 - 0.6)
            ylo, yhi = rlo + 0.5, rhi + 0.5
            y = ylo + u * (yhi - ylo)
        elif sc.monster_wall == "north":
            y = torch.full_like(u, rlo + 0.5 + 0.3)
            xlo, xhi = clo + 0.5, chi + 0.5
            x = xlo + u * (xhi - xlo)
        elif sc.monster_wall == "corridor":
            i = torch.arange(n, device=u.device)
            x = (6.0 + 2.6 * i.to(torch.float32)).expand_as(u)
            y = torch.where(i % 2 == 0, 10.6, 12.4).expand_as(u)
        else:  # "ring" or default: random free cells
            return self.free_cells[cell.long()]
        return torch.stack([x, y], -1)

    # -- world init -----------------------------------------------------

    def _init_world(self, d):
        sc, dev = self.sc, self.device
        N = d["spawn_cell"].shape[0]

        def full(v, *shape):
            return torch.full((N, *shape), v, dtype=torch.float32, device=dev)

        if sc.random_spawn:
            p0 = self.free_cells[d["spawn_cell"].long()]
            px, py, ang = p0[:, 0], p0[:, 1], d["spawn_ang"]
        else:
            px, py, ang = full(sc.spawn[0]), full(sc.spawn[1]), full(sc.spawn_ang)
        ammo = full(0.0, 8)
        ammo[:, sc.weapon] = sc.ammo0
        return {
            "px": px, "py": py, "ang": ang,
            "hp": full(100.0), "armor": full(0.0),
            "ammo": ammo, "sel_w": torch.full((N,), sc.weapon, dtype=torch.int32, device=dev),
            "kills": full(0.0), "hits": full(0.0),
            "dmg": full(0.0), "frags": full(0.0),
            "deaths": full(0.0),
            "mxy": self._monster_spawn(d["monster_u"], d["monster_cell"]),
            "mhp": full(sc.monster_hp if sc.n_monsters else 0.0, self.nm),
            "mcool": full(0.0, self.nm),
            "mlat": full(1.0, self.nm),
            "ixy": self.free_cells[d["item_cell"].long()],
            "ipresent": torch.full((N, self.ni), sc.n_items > 0, device=dev),
            "icool": full(0.0, self.ni),
            "rock": full(0.0, _NR, 4),
            "r_alive": torch.zeros(N, _NR, dtype=torch.bool, device=dev),
            "fb": full(0.0, _NF, 4),
            "fb_alive": torch.zeros(N, _NF, dtype=torch.bool, device=dev),
            "fcool": full(4.0),
            "flash": full(0.0), "hurt": full(0.0),
            "goal": full(0.0),
        }

    def _gvs(self, g):
        sel = torch.clamp(g["sel_w"], 0, 7).long()[:, None]
        a = g["ammo"]
        return torch.stack([
            a[:, 2], a[:, 3], a[:, 4], a[:, 5], a[:, 6], a[:, 7], g["armor"], g["dmg"],
            g["deaths"], g["frags"], g["hp"], g["hits"], g["kills"],
            g["sel_w"].to(torch.float32), a.gather(1, sel)[:, 0], g["goal"],
        ], 1)

    # -- rendering ------------------------------------------------------

    def _frame_float(self, g):
        """The frame ``[N, channels, h, w]`` of world ``g`` before
        rounding, in the dtype of ``g``'s positions."""
        sc = self.sc
        dt = g["px"].dtype
        goal = torch.as_tensor(sc.goal or (0.0, 0.0), dtype=dt, device=self.device)
        spr_xy = torch.cat([
            g["mxy"], g["ixy"], g["rock"][..., :2], g["fb"][..., :2],
            goal.expand(g["px"].shape[0], 1, 2),
        ], 1).to(dt)
        spr_alive = torch.cat([
            g["mhp"] > 0, g["ipresent"], g["r_alive"], g["fb_alive"],
            torch.full_like(g["r_alive"][:, :1], bool(sc.goal)),
        ], 1)
        frame = render_frame(
            self.walls, g["px"], g["py"], g["ang"], spr_xy, self.spr_type, spr_alive,
            flash=g["flash"], hurt=g["hurt"], weapon_up=1.0 if sc.ammo0 > 0 else 0.0,
            wall_cells=self.wall_cells,
        )  # [N, H, W, 3]
        if sc.channels == 1:
            chw = (0.299 * frame[..., 0] + 0.587 * frame[..., 1]
                   + 0.114 * frame[..., 2])[:, None]
        else:
            chw = frame.permute(0, 3, 1, 2)
        h, w = self._hw
        if (h, w) != (H, W):
            with full_fp32():
                chw = resize_area(chw, (h, w), dt)
        return chw

    def _frame(self, g):
        return torch.clamp(torch.round(self._frame_float(g)), 0, 255).to(torch.uint8)

    def frame_float(self, state):
        """The newest frame of env state ``state`` before rounding (for
        the frame rule of ``ops/thresholds.py``)."""
        return self._frame_float(state["g"])

    def frame_mask(self, mask, filled):
        """A ``[N, channels, h, w]`` mask of the newest frame → the stacked
        obs' ``[N, stack * channels, h, w]``: the older frames are the
        input's where the env stepped, the newest frame where it reset
        (``filled``)."""
        older = mask[:, None] & filled[:, None, None, None, None]
        older = older.expand(-1, self._stack - 1, *mask.shape[1:])
        return torch.cat([older.flatten(1, 2), mask], 1)

    def _push(self, stack, frame, fill: bool):
        if fill:
            return frame[:, None].expand_as(stack).contiguous()
        return torch.cat([stack[:, 1:], frame[:, None]], 1)

    def _obs(self, stack, g, gvs):
        h, w = self._hw
        out = {"obs": stack.reshape(stack.shape[0], self._stack * self.sc.channels, h, w)}
        for i, name in enumerate(GV_NAMES):
            out[f"info:{name}"] = gvs[:, i]
        return out

    # -- env API --------------------------------------------------------

    def reset_env(self, draws):
        g = self._init_world(draws)
        frame = self._frame(g)
        h, w = self._hw
        shape = (frame.shape[0], self._stack, self.sc.channels, h, w)
        stack = self._push(torch.empty(shape, dtype=torch.uint8, device=self.device), frame, True)
        gvs = self._gvs(g)
        state = {"g": g, "stack": stack, "gvs": gvs,
                 "sel_count": torch.ones_like(g["sel_w"])}
        return state, self._obs(stack, g, gvs)

    def step_env(self, state, action, draws):
        sc, skip = self.sc, self.skip
        old = state["g"]
        g = dict(old)
        N = old["px"].shape[0]

        # --- decode action → button vector ---
        if self.combined:
            a = torch.clamp(action.reshape(-1).to(torch.int32), 0, self.action_set.shape[0] - 1)
            b = self.action_set[a.long()]
        else:
            b = action.reshape(N, len(self.buttons)).to(torch.float32)
        atk = self._press(b, B.ATTACK) > 0.5
        spd = torch.where(self._press(b, B.SPEED) > 0.5, 1.4, 1.0)
        if bool(self.config["force_speed"]) and B.SPEED in self.buttons:
            spd = torch.full_like(spd, 1.4)
        def axis(plus, minus):
            return self._press(b, plus) - self._press(b, minus)

        turn = axis(B.TURN_RIGHT, B.TURN_LEFT) * _TURN * skip
        fwd = axis(B.MOVE_FORWARD, B.MOVE_BACKWARD) * _MOVE * skip * spd
        strafe = axis(B.MOVE_RIGHT, B.MOVE_LEFT) * _MOVE * skip * spd

        ang = old["ang"] + turn
        ca, sa = torch.cos(ang), torch.sin(ang)
        dx = fwd * ca + strafe * -sa
        dy = fwd * sa + strafe * ca
        nx = old["px"] + dx
        ny = old["py"] + dy
        px = torch.where(self._pos_free(nx, old["py"]), nx, old["px"])
        py = torch.where(self._pos_free(px, ny), ny, old["py"])
        g["px"], g["py"], g["ang"] = px, py, ang

        # --- weapon select ---
        sel_w = old["sel_w"]
        for bid, slot in _W2SLOT.items():
            if bid in self.buttons:
                sel_w = torch.where(self._press(b, bid) > 0.5, slot, sel_w)
        g["sel_w"] = sel_w = sel_w.to(torch.int32)

        # --- attack ---
        sel_i = torch.clamp(sel_w, 0, 7)
        sel = _slot_mask(sel_i, 8)
        ammo = old["ammo"]
        can_fire = atk & (ammo.gather(1, sel_i.long()[:, None])[:, 0] > 0)
        g["ammo"] = torch.where(sel & can_fire[:, None], ammo - 1.0, ammo)
        alive = old["mhp"] > 0
        mdx = old["mxy"][..., 0] - px[:, None]
        mdy = old["mxy"][..., 1] - py[:, None]
        mdist = torch.sqrt(mdx * mdx + mdy * mdy) + 1e-6
        angoff = torch.abs(
            mod(torch.atan2(mdy, mdx) - ang[:, None] + math.pi, 2 * math.pi) - math.pi)
        los = self._los(px, py, old["mxy"][..., 0], old["mxy"][..., 1])
        in_aim = (alive & los & (mdist < 24.0)
                  & (angoff < torch.atan2(torch.full_like(mdist, 0.45), mdist) + 0.04))
        if not sc.projectile:
            target = first_argmin(torch.where(in_aim, mdist, 1e9))
            hit = can_fire & in_aim.any(1)
            dmg_vec = torch.where(_slot_mask(target, self.nm) & hit[:, None], sc.attack_dmg, 0.0)
            g["mhp"] = torch.clamp(old["mhp"] - dmg_vec, min=0.0)
            g["hits"] = old["hits"] + torch.where(hit, 1.0, 0.0)
            g["dmg"] = old["dmg"] + torch.where(hit, sc.attack_dmg, 0.0)
        else:
            # spawn a rocket into a free slot
            slot = first_argmin(old["r_alive"])
            at = _slot_mask(slot, _NR)
            fire = can_fire & ~(old["r_alive"] & at).any(1)
            new_rock = torch.stack([px, py, ca * 0.9, sa * 0.9], 1)
            launch = at & fire[:, None]
            rock = torch.where(launch[..., None], new_rock[:, None], old["rock"])
            r_alive = old["r_alive"] | launch

            # --- advance rockets (player projectiles) ---
            pos = rock[..., :2] + rock[..., 2:]
            wall_hit = ~self._cell_free(pos[..., 0], pos[..., 1])
            d = pos[:, :, None, :] - old["mxy"][:, None, :, :]
            rd = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])  # [N, NR, NM]
            boom = (rd < 0.8) & r_alive[..., None] & alive[:, None, :]
            n_hit = boom.any(2).sum(1)
            g["mhp"] = torch.clamp(old["mhp"] - boom.sum(1) * sc.attack_dmg, min=0.0)
            g["hits"] = old["hits"] + n_hit
            g["dmg"] = old["dmg"] + n_hit * sc.attack_dmg
            g["r_alive"] = r_alive & ~wall_hit & ~boom.any(2)
            g["rock"] = torch.cat([pos, rock[..., 2:]], -1)

        # --- kill accounting (any monster that just died) ---
        died = (old["mhp"] > 0) & (g["mhp"] <= 0)
        n_died = died.to(torch.float32).sum(1)
        if sc.frags:
            g["frags"] = old["frags"] + n_died
        g["kills"] = old["kills"] + n_died

        # --- monster AI ---
        alive = g["mhp"] > 0
        if sc.monster_lateral > 0:
            ylo, yhi = self.free_rows[0] + 1.0, self.free_rows[1]
            my = g["mxy"][..., 1] + old["mlat"] * sc.monster_lateral
            bounce = (my < ylo) | (my > yhi)
            g["mlat"] = torch.where(bounce, -old["mlat"], old["mlat"])
            g["mxy"] = torch.stack([g["mxy"][..., 0], torch.clamp(my, ylo, yhi)], -1)
        if sc.monster_speed > 0:
            ux = -mdx / mdist
            uy = -mdy / mdist
            step_m = sc.monster_speed * skip
            nmx = g["mxy"][..., 0] - ux * step_m
            nmy = g["mxy"][..., 1] - uy * step_m
            move = alive & self._cell_free(nmx, nmy) & (mdist > 1.0)
            g["mxy"] = torch.where(move[..., None], torch.stack([nmx, nmy], -1), g["mxy"])

        damage_in = torch.zeros_like(px)
        cool = torch.clamp(old["mcool"] - 1.0, min=0.0)
        if sc.monster_melee > 0:
            biting = alive & (mdist < 1.4) & (cool <= 0)
            damage_in = damage_in + biting.sum(1) * sc.monster_melee
            cool = torch.where(biting, 3.0, cool)
        if sc.monster_ranged > 0:
            shooting = alive & (mdist < 14.0) & los & (cool <= 0)
            damage_in = damage_in + shooting.sum(1) * sc.monster_ranged
            cool = torch.where(shooting, 2.0, cool)
        g["mcool"] = cool

        # --- respawn dead monsters ---
        if sc.monster_respawn:
            timer = torch.where(died, 12.0, g["mcool"])
            respawn = ~alive & (timer <= 0)
            spawn_xy = self._monster_spawn(draws["respawn_u"], draws["respawn_cell"])
            g["mxy"] = torch.where(respawn[..., None], spawn_xy, g["mxy"])
            g["mhp"] = torch.where(respawn, sc.monster_hp, g["mhp"])
            g["mcool"] = torch.where(~alive, torch.clamp(timer - 1.0, min=0.0), g["mcool"])

        # --- incoming fireballs (take_cover) ---
        if sc.fireballs > 0:
            fb = old["fb"]
            fpos = fb[..., :2] + fb[..., 2:]
            wall_hit = ~self._cell_free(fpos[..., 0], fpos[..., 1])
            fdx, fdy = fpos[..., 0] - px[:, None], fpos[..., 1] - py[:, None]
            hit_p = (torch.sqrt(fdx * fdx + fdy * fdy) < 0.8) & old["fb_alive"]
            damage_in = damage_in + hit_p.sum(1) * sc.fireball_dmg
            fb_alive = old["fb_alive"] & ~wall_hit & ~hit_p
            fcool = old["fcool"] - 1.0
            # launch: aim at the player's current x from the north wall
            slot = first_argmin(fb_alive)
            at = _slot_mask(slot, _NF)
            can = (fcool <= 0) & ~(fb_alive & at).any(1)
            oy = self.free_rows[0] + 0.6
            ox = px + draws["fb_dx"]
            vx, vy = px - ox, py - oy
            norm = torch.sqrt(vx * vx + vy * vy) + 1e-6
            newf = torch.stack([ox, torch.full_like(ox, oy), vx / norm * 0.7, vy / norm * 0.7], 1)
            launch = at & can[:, None]
            g["fb"] = torch.where(launch[..., None], newf[:, None],
                                  torch.cat([fpos, fb[..., 2:]], -1))
            g["fb_alive"] = fb_alive | launch
            g["fcool"] = torch.where(can, 6.0, torch.clamp(fcool, min=0.0))

        # --- items ---
        if sc.n_items > 0:
            idx_ = old["ixy"][..., 0] - px[:, None]
            idy_ = old["ixy"][..., 1] - py[:, None]
            grab = old["ipresent"] & (torch.sqrt(idx_ * idx_ + idy_ * idy_) < 0.8)
            it = self.item_type

            def count(kind):
                return (grab & (it == kind)).sum(1)

            g["hp"] = torch.clamp(old["hp"] + count(SPR_MEDKIT) * 25.0, max=100.0)
            damage_in = damage_in + count(SPR_POISON) * 30.0
            g["armor"] = torch.clamp(old["armor"] + count(SPR_ARMOR) * 50.0, max=200.0)
            g["ammo"] = torch.where(sel, g["ammo"] + (count(SPR_AMMO) * 10.0)[:, None], g["ammo"])
            icool = torch.where(grab, 20.0, torch.clamp(old["icool"] - 1.0, min=0.0))
            present = old["ipresent"] & ~grab
            if sc.item_respawn:
                back = ~present & (icool <= 0)
                new_xy = self.free_cells[draws["item_cell"].long()]
                g["ixy"] = torch.where(back[..., None], new_xy, old["ixy"])
                present = present | back
            g["ipresent"] = present
            g["icool"] = icool

        # --- health drain, armor absorption, death ---
        absorbed = torch.minimum(g["armor"], damage_in * (1.0 / 3.0))
        g["armor"] = g["armor"] - absorbed
        hp = g["hp"] - (damage_in - absorbed) - sc.health_drain * skip
        g["hp"] = torch.clamp(hp, min=0.0)
        just_died = (old["hp"] > 0) & (g["hp"] <= 0)
        g["deaths"] = old["deaths"] + torch.where(just_died, 1.0, 0.0)

        # --- goal ---
        if sc.goal:
            gx, gy = px - sc.goal[0], py - sc.goal[1]
            g["goal"] = torch.where(torch.sqrt(gx * gx + gy * gy) < 1.0, 1.0, old["goal"])

        g["flash"] = torch.where(can_fire, 1.0, old["flash"] * 0.5)
        g["hurt"] = torch.clamp(damage_in * (1.0 / 30.0), 0.0, 1.0)

        # --- termination ---
        done = g["hp"] <= 0
        if sc.goal:
            done = done | (g["goal"] > 0)
        if sc.kill_all_ends:
            done = done | (g["mhp"] <= 0).all(1)

        # --- reward (reference delta machinery) ---
        gvs = self._gvs(g)
        same_w = g["sel_w"] == old["sel_w"]
        sel_count = torch.where(same_w, state["sel_count"] + 1, 1).to(torch.int32)
        reward = shaped_reward(gvs, state["gvs"], sel_count, int(self.config["weapon_duration"]))

        stack = self._push(state["stack"], self._frame(g), False)
        new_state = {"g": g, "stack": stack, "gvs": gvs, "sel_count": sel_count}
        return EnvOut(
            state=new_state,
            obs=self._obs(stack, g, gvs),
            reward=reward.to(torch.float32),
            terminated=done,
        )
