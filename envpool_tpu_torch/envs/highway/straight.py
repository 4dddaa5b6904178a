"""Highway (the straight multi-lane road), batched in PyTorch.

Counterpart of ``envpool_tpu/envs/highway/straight.py`` (reference:
``envpool/highway/highway_env.{h,cc}``).  The state holds ``[N, V]``
vehicles (``V = 1 + vehicles_count``; row 0 is the ego, the rest IDM
traffic with MOBIL lane changes); neighbour queries, lane changes and the
rotated-rectangle collision test are ``[N, V, V]`` programs, and the
``simulation_frequency // policy_frequency`` substeps a Python loop.

The JAX env's documented deviations carry over: traffic decisions are
taken synchronously from the state before each substep.  Its one-hot
contractions select exact values, so they are gathers here.  Its reset
places the cars by a float32 ``cumsum``, which XLA on the CPU sums in
blocks of 16 (sequential within a block, then the blocks' totals in
order, then each block's carry added to its partial sums); the port adds
in that order (:func:`cumsum16`), so ``x`` and the lane-change timer
``mod((x + y) * pi, 1)`` equal JAX's bit for bit, on the card and on the
CPU alike.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ...core.env import EnvOut, TorchEnv
from ...core.rng import Draws
from ...core.specs import ArraySpec
from ...ops.batched import const, mod
from .network import asin, atan, cos, f32, lmap, notzero, pow, sin, tan, wrap_pi

_PI = math.pi
_LANE_WIDTH = 4.0
_LANE_LENGTH = 10000.0
_LENGTH = 5.0  # vehicle length
_WIDTH = 2.0
_MAX_SPEED = 40.0
_MIN_SPEED = -40.0
_PERCEPTION = 5.0 * _MAX_SPEED

_KP_A = 1.0 / 0.6
_KP_HEADING = 1.0 / 0.2
_KP_LATERAL = 1.0 / 0.6
_MAX_STEER = _PI / 3.0

_IDM_ACC_MAX = 6.0
_IDM_COMFORT_ACC_MAX = 3.0
_IDM_COMFORT_ACC_MIN = -5.0
_IDM_DIST_WANTED = 5.0 + _LENGTH
_IDM_TIME_WANTED = 1.5
_LC_MIN_ACC_GAIN = 0.2
_LC_MAX_BRAKING = 2.0
_LC_DELAY = 1.0

_EGO_SPEEDS = (20.0, 25.0, 30.0)
# 2 * sqrt(-IDM_COMFORT_ACC_MAX * IDM_COMFORT_ACC_MIN), in float32.
_GAP_DIV = f32(2.0 * np.float32(np.sqrt(np.float32(15.0))))


def cumsum16(a: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` along the last axis in float32 as XLA computes it on
    the CPU: sequential sums within blocks of 16, a sequential scan of the
    blocks' totals, each block's carry added to its partial sums."""
    cols, carry = [], None
    for b0 in range(0, a.shape[-1], 16):
        p = None
        for i in range(b0, min(a.shape[-1], b0 + 16)):
            p = a[..., i] if p is None else p + a[..., i]
            cols.append(p if carry is None else carry + p)
        carry = p if carry is None else carry + p
    return torch.stack(cols, -1)


def _set0(t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``t`` with column 0 replaced by ``v`` (a new tensor)."""
    return torch.cat([v[:, None].to(t.dtype), t[:, 1:]], 1)


def _steering_control(y, heading, speed, target_lane):
    """Pure-pursuit steering toward a straight lane (highway_env.cc:640-660)."""
    lateral = y - _LANE_WIDTH * target_lane.to(torch.float32)
    lat_cmd = f32(-_KP_LATERAL) * lateral
    heading_cmd = asin(torch.clamp(lat_cmd / notzero(speed), -1.0, 1.0))
    heading_ref = torch.clamp(heading_cmd, f32(-_PI / 4), f32(_PI / 4))
    rate_cmd = f32(_KP_HEADING) * wrap_pi(heading_ref - heading)
    slip = asin(torch.clamp(f32(_LENGTH / 2.0) / notzero(speed) * rate_cmd, -1.0, 1.0))
    return torch.clamp(atan(2.0 * tan(slip)), f32(-_MAX_STEER), f32(_MAX_STEER))


def _closest_lane(y, lanes_count):
    return torch.clamp(torch.round(y * f32(1.0 / _LANE_WIDTH)).to(torch.int32), 0,
                       lanes_count - 1)


def _idm_acc(delta, speed, target_speed, c, s, ego_vx, ego_vy, ego_x, front_valid, front_x,
             front_vx, front_vy):
    """IDM acceleration (highway_env.cc:781-807); ``delta`` is the decider's,
    ``(c, s)`` the ego's heading's cosine and sine."""
    ets = torch.clamp(target_speed, 0.0, 30.0)
    acc = _IDM_COMFORT_ACC_MAX * (
        1.0 - pow(torch.clamp_min(speed, 0.0) / notzero(ets).abs(), delta))
    d = front_x - ego_x
    dv = (ego_vx - front_vx) * c + (ego_vy - front_vy) * s
    gap = _IDM_DIST_WANTED + speed * _IDM_TIME_WANTED + speed * dv * f32(1.0 / _GAP_DIV)
    q = gap / notzero(d)
    return acc - torch.where(front_valid, _IDM_COMFORT_ACC_MAX * (q * q), 0.0)


class HighwayEnv(TorchEnv):
    """highway-v0 / highway-fast-v0 (envpool/highway/highway_env.h:122-166)."""

    DEFAULT_CONFIG: dict[str, Any] = {
        "lanes_count": 4,
        "vehicles_count": 50,
        "observation_vehicles_count": 5,
        "controlled_vehicles": 1,
        "initial_lane_id": -1,
        "duration": 40,
        "simulation_frequency": 15,
        "policy_frequency": 1,
        "ego_spacing": 2.0,
        "vehicles_density": 1.0,
        "collision_reward": -1.0,
        "right_lane_reward": 0.1,
        "high_speed_reward": 0.4,
        "lane_change_reward": 0.0,
        "reward_speed_low": 20.0,
        "reward_speed_high": 30.0,
        "normalize_reward": True,
        "offroad_terminal": False,
        "other_vehicles_check_collisions": True,
        "screen_width": 600,
        "screen_height": 150,
        "centering_position_x": 0.3,
        "centering_position_y": 0.5,
        "scaling": 5.5,
    }

    def __init__(self, config):
        super().__init__(config)
        v = self._v
        dev = self.device
        self._eye = torch.eye(v, dtype=torch.bool, device=dev)
        self._rows = torch.arange(v, device=dev)
        self._traffic = self._rows >= 1
        check = torch.full((v,), bool(config["other_vehicles_check_collisions"]),
                           dtype=torch.bool, device=dev)
        check[0] = True
        self._pairs = (check[:, None] | check[None, :]) & ~self._eye

    # -- specs ---------------------------------------------------------------

    def state_spec(self):
        inf = float("inf")
        f = int(self.config["observation_vehicles_count"])
        return {
            "obs": ArraySpec(np.float32, (f, 5), -inf, inf),
            "info:speed": ArraySpec(np.float32, ()),
            "info:crashed": ArraySpec(np.bool_, ()),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.int32, (), 0, 4, is_discrete=True)}

    @property
    def _v(self) -> int:
        return 1 + int(self.config["vehicles_count"])

    @property
    def _lanes(self) -> int:
        return int(self.config["lanes_count"])

    # -- reset -----------------------------------------------------------------

    def plan_reset(self, d):
        """The reset's draws, in the JAX env's order (``reset_env``)."""
        v, lanes = self._v, self._lanes
        d.randint("lane", 0, lanes, (v,))
        if int(self.config["initial_lane_id"]) < 0:
            d.randint("ego_lane", 0, lanes)
        d.uniform("speed", (v,), 0.7 * 30.0, 0.8 * 30.0)
        d.uniform("u", (v,), 0.9, 1.1)
        d.uniform("delta", (v,), 3.5, 4.5)

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    def reset_env(self, draws):
        lanes = self._lanes
        lane = draws["lane"]
        n = lane.shape[0]
        ego_cfg = int(self.config["initial_lane_id"])
        if ego_cfg >= 0:
            ego_lane = torch.full((n,), min(max(ego_cfg, 0), lanes - 1), dtype=torch.int32,
                                  device=lane.device)
        else:
            ego_lane = draws["ego_lane"]
        lane = _set0(lane, ego_lane)
        speed = _set0(draws["speed"], torch.full((n,), 25.0, device=lane.device))
        # Longitudinal placement: strictly increasing x, the sequential "max
        # over previous x" as a cumulative sum (highway_env.cc:483-521).
        density = float(self.config["vehicles_density"])
        spacing = torch.full_like(speed, f32(1.0 / max(density, 1e-6)))
        spacing = _set0(spacing, torch.full((n,), f32(self.config["ego_spacing"]),
                                            device=lane.device))
        # jnp.exp(-5/40 * lanes), folded by XLA to the float32 constant
        scale = float(np.exp(np.float32(-5.0 / 40.0) * np.float32(lanes)))
        offset = spacing * (12.0 + speed) * scale
        step_x = offset * draws["u"]
        x = cumsum16(step_x) + 3.0 * offset[:, :1]
        y = _LANE_WIDTH * lane.to(torch.float32)
        zeros = torch.zeros_like(x)
        st = {
            "x": x,
            "y": y,
            "heading": zeros,
            "speed": speed,
            "target_lane": lane,
            "target_speed": speed,
            "timer": mod((x + y) * f32(_PI), _LC_DELAY),
            "idm_delta": draws["delta"],
            "crashed": torch.zeros_like(x, dtype=torch.bool),
            "impact": torch.zeros((*x.shape, 2), device=x.device),
            "has_impact": torch.zeros_like(x, dtype=torch.bool),
        }
        return st, self._obs(st)

    # -- helpers ---------------------------------------------------------------

    def _lane_tables(self, st):
        """Front and rear vehicle of every row in every lane: ``[N, L, V]``
        indices and validity (NeighbourVehicles, highway_env.cc:742-775),
        the first index on ties, as ``jnp.argmin`` / ``argmax``."""
        x, y = st["x"], st["y"]
        lanes = const(tuple(_LANE_WIDTH * k for k in range(self._lanes)), x.device)
        in_x = (x >= -_LENGTH) & (x < _LANE_LENGTH + _LENGTH)
        member = ((y[:, None, :] - lanes[None, :, None]).abs()
                  <= _LANE_WIDTH / 2.0 + 1.0) & in_x[:, None, :]        # [N, L, V]
        ok = member[:, :, None, :] & ~self._eye                          # [N, L, V, V]
        xge = (x[:, None, :] >= x[:, :, None])[:, None]                  # [N, 1, V, V]
        fm = ok & xge
        rm = ok & ~xge
        xj = x[:, None, None, :]
        fi = torch.where(fm, xj, float("inf")).argmin(-1)
        ri = torch.where(rm, xj, float("-inf")).argmax(-1)
        return fi, fm.any(-1), ri, rm.any(-1)

    def _from_tables(self, tables, lane_q):
        """``(front_idx, front_valid, rear_idx, rear_valid)`` ``[N, Q, V]``
        for query lanes ``lane_q`` ``[N, Q, V]`` (out-of-range lanes:
        invalid)."""
        fi, fv, ri, rv = tables
        inb = (lane_q >= 0) & (lane_q < self._lanes)
        idx = lane_q.clamp(0, self._lanes - 1).long()
        return (fi.gather(1, idx), fv.gather(1, idx) & inb, ri.gather(1, idx),
                rv.gather(1, idx) & inb)

    @staticmethod
    def _fields(st):
        """``[N, V, 7]``: speed, target speed, vx, vy, x and the heading's
        cosine and sine of every row, for gathers by row."""
        c, s = cos(st["heading"]), sin(st["heading"])
        return torch.stack([st["speed"], st["target_speed"], st["speed"] * c,
                            st["speed"] * s, st["x"], c, s], -1)

    @staticmethod
    def _rows_of(fields, idx):
        """The fields of rows ``idx`` ``[N, Q, V]``: ``[N, Q, V, 7]``."""
        n, q, v = idx.shape
        flat = idx.long().reshape(n, q * v, 1).expand(n, q * v, fields.shape[-1])
        return fields.gather(1, flat).reshape(n, q, v, -1)

    def _idm(self, fields, delta, ego_idx, ego_valid, front_idx, front_valid):
        """IDM acc ``[N, Q, V]`` of vehicle ``ego_idx`` (None: the row
        itself) following ``front_idx``, per query and row, with the
        deciding row's ``delta`` (``_idm_pair`` of the JAX env, one
        elementwise program for all queries)."""
        ego = fields[:, None] if ego_idx is None else self._rows_of(fields, ego_idx)
        front = self._rows_of(fields, front_idx)
        spd, tspd, vx, vy, x, c, s = ego.unbind(-1)
        _, _, fvx, fvy, fx, _, _ = front.unbind(-1)
        acc = _idm_acc(delta[:, None], spd, tspd, c, s, vx, vy, x, front_valid, fx, fvx, fvy)
        return acc if ego_valid is None else torch.where(ego_valid, acc, 0.0)

    def _change_lane_policy(self, st, fields, lane, tables):
        """New (target_lane, timer) for traffic rows (highway_env.cc:809-844),
        and each row's IDM acc behind its front in its own lane."""
        x = st["x"]
        target = st["target_lane"]
        changing = lane != target
        # Abort an ongoing change if another vehicle is already heading into
        # the same target lane closer than the desired gap ahead of us.
        spd, _, vx, vy, _, c, s = fields.unbind(-1)
        dv = ((vx[:, :, None] - vx[:, None, :]) * c[:, :, None]
              + (vy[:, :, None] - vy[:, None, :]) * s[:, :, None])
        gap = (_IDM_DIST_WANTED + spd[:, :, None] * _IDM_TIME_WANTED
               + spd[:, :, None] * dv * f32(1.0 / _GAP_DIV))
        d = x[:, None, :] - x[:, :, None]
        conflict = ((lane[:, None, :] != target[:, :, None])
                    & (target[:, None, :] == target[:, :, None])
                    & ~self._eye & (d > 0.0) & (d < gap)).any(-1)
        target_after_abort = torch.where(changing & conflict, lane, target)

        # Not changing: when the per-vehicle timer expires, consider both side
        # lanes (left first) through MOBIL (politeness 0;
        # highway_env.cc:846-884), both sides in one program.
        may_consider = ~changing & (st["timer"] > _LC_DELAY)
        new_timer = torch.where(may_consider, 0.0, st["timer"])
        moving = spd.abs() >= 1.0
        left, right = lane - 1, lane + 1
        fi, fv, ri, rv = self._from_tables(tables, torch.stack([left, right, lane], 1))
        n, v = x.shape
        rows = self._rows[None, None].expand(n, 2, v)
        ones = torch.ones_like(rv)
        # the new followers behind us (the row's delta), us behind the new
        # fronts, us behind the old front
        acc = self._idm(fields, st["idm_delta"], torch.cat([ri[:, :2], rows, rows[:, :1]], 1),
                        torch.cat([rv[:, :2], ones], 1),
                        torch.cat([rows, fi], 1), torch.cat([ones[:, :2], fv], 1))
        safe = acc[:, :2] >= -_LC_MAX_BRAKING
        gain = acc[:, 2:4] - acc[:, 4:5] >= _LC_MIN_ACC_GAIN
        y = st["y"]

        def ok(cand, k):
            lat = y - _LANE_WIDTH * cand.to(torch.float32)
            return (may_consider & (cand >= 0) & (cand < self._lanes)
                    & (lat.abs() <= 2.0 * _LANE_WIDTH) & (x >= 0.0)
                    & (x < _LANE_LENGTH + _LENGTH) & moving & safe[:, k] & gain[:, k])

        new_target = torch.where(ok(left, 0), left,
                                 torch.where(ok(right, 1), right, target_after_abort))
        return new_target, new_timer, acc[:, 4]

    def _collide(self, st, dt):
        """Batched rotated-rect SAT with velocity lookahead over all pairs
        (``CollidePolygons``, highway_env.cc:312-391): the 4 separating axes
        stacked on one axis, the axis of the least ``|distance|`` the first
        on ties (the JAX env's tournament on ``ad < min_dist``); returns
        (crashed now, has impact, impact ``[N, V, 2]``)."""
        x, y, heading = st["x"], st["y"], st["heading"]
        n, v = x.shape
        c, s = cos(heading), sin(heading)
        dispx = st["speed"] * c * dt
        dispy = st["speed"] * s * dt
        dxm = x[:, None, :] - x[:, :, None]          # center_j - center_i
        dym = y[:, None, :] - y[:, :, None]
        ddx = dispx[:, :, None] - dispx[:, None, :]  # disp_i - disp_j
        ddy = dispy[:, :, None] - dispy[:, None, :]
        ci, si = c[:, :, None], s[:, :, None]
        cj, sj = c[:, None, :], s[:, None, :]
        acosd = (ci * cj + si * sj).abs()
        asind = (si * cj - ci * sj).abs()
        hl, hw = _LENGTH / 2.0, _WIDTH / 2.0
        # (axis ux, axis uy, r_i, r_j) of the axes dir_i, perp_i, dir_j, perp_j
        ux = torch.cat([ci.expand(n, v, v)[:, None], (-si).expand(n, v, v)[:, None],
                        cj.expand(n, v, v)[:, None], (-sj).expand(n, v, v)[:, None]], 1)
        uy = torch.cat([si.expand(n, v, v)[:, None], ci.expand(n, v, v)[:, None],
                        sj.expand(n, v, v)[:, None], cj.expand(n, v, v)[:, None]], 1)
        r_l = (hl * acosd + hw * asind)[:, None]
        r_w = (hl * asind + hw * acosd)[:, None]
        halves = const((hl, hw), x.device)[None, :, None, None].expand(n, 2, v, v)
        ri = torch.cat([halves, r_l, r_w], 1)
        rj = torch.cat([r_l, r_w, halves], 1)
        p = ux * dxm[:, None] + uy * dym[:, None]            # dcenter . u
        vp = ux * ddx[:, None] + uy * ddy[:, None]           # rel-disp . u
        ds = p.abs() - (ri + rj)                             # symmetric intervals
        al = -ri + torch.clamp_max(vp, 0.0)
        ah = ri + torch.clamp_min(vp, 0.0)
        dd = torch.where(al < p - rj, (p - rj) - ah, al - (p + rj))
        intersecting = (ds <= 0.0).all(1)
        will = (dd <= 0.0).all(1)
        min_dist, k = dd.abs().min(1, keepdim=True)
        bux, buy = ux.gather(1, k)[:, 0], uy.gather(1, k)[:, 0]
        min_dist = min_dist[:, 0]
        # Minimum-translation vector toward i.
        pbest = bux * dxm + buy * dym
        sign = torch.where(-pbest > 0.0, 1.0, -1.0)
        # Early-distance cull (highway_env.cc:362-374).
        dist_centers = torch.sqrt(dxm * dxm + dym * dym)
        diag = math.sqrt(_LENGTH**2 + _WIDTH**2)
        near = dist_centers <= f32(diag) + torch.sqrt(dispx * dispx + dispy * dispy)[:, :, None]
        pair = self._pairs & near
        hit = pair & will
        crashed_now = (pair & intersecting).any(-1)
        has_impact = hit.any(-1)
        # The first hitting j of each row.
        first = hit.to(torch.int8).argmax(-1, keepdim=True)
        m = sign * min_dist
        impact = 0.5 * torch.stack([(m * bux).gather(2, first)[..., 0],
                                    (m * buy).gather(2, first)[..., 0]], -1)
        impact = torch.where(has_impact[..., None], impact, 0.0)
        return crashed_now, has_impact, impact

    # -- step ------------------------------------------------------------------

    def _apply_meta_action(self, st, action):
        """Ego meta-action -> target speed / target lane (highway_env.cc:585-625)."""
        lanes = self._lanes
        action = torch.clamp(action.reshape(-1).to(torch.int32), 0, 4)
        speed0 = st["speed"][:, 0]
        # FASTER / SLOWER: re-index from the *current* speed.
        idx = torch.clamp(torch.round((speed0 - 20.0) * f32(1.0 / 10.0) * 2.0).to(torch.int32),
                          0, 2)
        idx = torch.where(action == 3, idx + 1, torch.where(action == 4, idx - 1, idx))
        idx = torch.clamp(idx, 0, 2)
        speeds = const(_EGO_SPEEDS, speed0.device)
        change_speed = (action == 3) | (action == 4)
        new_target_speed = torch.where(change_speed, speeds[idx.long()], st["target_speed"][:, 0])
        # LANE_LEFT / LANE_RIGHT on the *target* lane, if reachable.
        tl = st["target_lane"][:, 0]
        cand = torch.clamp(tl + torch.where(action == 2, 1, torch.where(action == 0, -1, 0)),
                           0, lanes - 1).to(torch.int32)
        lat = st["y"][:, 0] - _LANE_WIDTH * cand.to(torch.float32)
        x0 = st["x"][:, 0]
        reachable = (lat.abs() <= 2.0 * _LANE_WIDTH) & (x0 >= 0.0) & (x0 < _LANE_LENGTH + _LENGTH)
        new_tl = torch.where(((action == 0) | (action == 2)) & reachable, cand, tl)
        return dict(st, target_speed=_set0(st["target_speed"], new_target_speed),
                    target_lane=_set0(st["target_lane"], new_tl))

    def _substep(self, st, dt):
        lane = _closest_lane(st["y"], self._lanes)
        tables = self._lane_tables(st)
        fields = self._fields(st)

        # Traffic lane-change decisions (rows >= 1, not crashed).
        new_target, new_timer, acc_idm = self._change_lane_policy(st, fields, lane, tables)
        act_traffic = self._traffic & ~st["crashed"]
        target_lane = torch.where(act_traffic, new_target, st["target_lane"])
        timer = torch.where(act_traffic, new_timer, st["timer"])

        # Controls.
        steering = _steering_control(st["y"], st["heading"], st["speed"], target_lane)
        accel_ctrl = f32(_KP_A) * (st["target_speed"] - st["speed"])  # ego row

        tfront_idx, tfront_v, _, _ = self._from_tables(tables, target_lane[:, None])
        acc_idm_t = self._idm(fields, st["idm_delta"], None, None, tfront_idx, tfront_v)[:, 0]
        acc_idm = torch.where(lane != target_lane, torch.minimum(acc_idm, acc_idm_t), acc_idm)
        acc_idm = torch.clamp(acc_idm, -_IDM_ACC_MAX, _IDM_ACC_MAX)
        accel = torch.where(self._traffic, acc_idm, accel_ctrl)

        # Kinematic bicycle step (highway_env.cc:690-723).
        crashed = st["crashed"]
        speed = st["speed"]
        steering = torch.where(crashed, 0.0, steering)
        accel = torch.where(crashed, -speed, accel)
        accel = torch.where(speed > _MAX_SPEED, torch.minimum(accel, _MAX_SPEED - speed), accel)
        accel = torch.where(speed < _MIN_SPEED, torch.maximum(accel, _MIN_SPEED - speed), accel)
        beta = atan(0.5 * tan(steering))
        hb = st["heading"] + beta
        has = st["has_impact"]
        x = st["x"] + speed * cos(hb) * dt
        y = st["y"] + speed * sin(hb) * dt
        x = x + torch.where(has, st["impact"][..., 0], 0.0)
        y = y + torch.where(has, st["impact"][..., 1], 0.0)
        heading = st["heading"] + speed * sin(beta) * f32(1.0 / (_LENGTH / 2.0)) * dt
        new = dict(st, x=x, y=y, heading=heading, speed=speed + accel * dt,
                   target_lane=target_lane,
                   timer=timer + torch.where(self._traffic, dt, 0.0),
                   crashed=crashed | has)
        crashed_now, has_impact, impact = self._collide(new, dt)
        new.update(crashed=new["crashed"] | crashed_now, has_impact=has_impact, impact=impact)
        return new

    def _on_road(self, st):
        lane = _closest_lane(st["y"][:, 0], self._lanes)
        lat = st["y"][:, 0] - _LANE_WIDTH * lane.to(torch.float32)
        x0 = st["x"][:, 0]
        return (lat.abs() <= _LANE_WIDTH / 2.0) & (x0 >= -_LENGTH) & (x0 < _LANE_LENGTH + _LENGTH)

    def step_env(self, state, action, draws):
        del draws
        cfg = self.config
        sim_freq = int(cfg["simulation_frequency"])
        frames = max(1, sim_freq // int(cfg["policy_frequency"]))
        dt = f32(1.0 / float(sim_freq))
        st = self._apply_meta_action(state, action)
        for _ in range(frames):
            st = self._substep(st, dt)
        on_road = self._on_road(st)
        terminated = st["crashed"][:, 0]
        if bool(cfg["offroad_terminal"]):
            terminated = terminated | ~on_road
        return EnvOut(state=st, obs=self._obs(st), reward=self._reward(st, on_road),
                      terminated=terminated)

    def _reward(self, st, on_road):
        cfg = self.config
        lanes = self._lanes
        ego_lane = st["target_lane"][:, 0].to(torch.float32)
        forward_speed = st["speed"][:, 0] * cos(st["heading"][:, 0])
        scaled = lmap(forward_speed, float(cfg["reward_speed_low"]),
                      float(cfg["reward_speed_high"]), 0.0, 1.0)
        cr = float(cfg["collision_reward"])
        rl = float(cfg["right_lane_reward"])
        hs = float(cfg["high_speed_reward"])
        reward = (cr * st["crashed"][:, 0].to(torch.float32)
                  + rl * ego_lane / max(lanes - 1, 1)
                  + hs * torch.clamp(scaled, 0.0, 1.0))
        if bool(cfg["normalize_reward"]):
            reward = lmap(reward, cr, hs + rl, 0.0, 1.0)
        return reward * on_road.to(torch.float32)

    def _obs(self, st):
        """Kinematics observation (highway_env.cc:904-958)."""
        f = int(self.config["observation_vehicles_count"])
        lanes = self._lanes
        x, y = st["x"], st["y"]
        c, s = cos(st["heading"]), sin(st["heading"])
        vx, vy = st["speed"] * c, st["speed"] * s

        def norm_row(px, py, pvx, pvy):
            nx = torch.clamp(lmap(px, -_PERCEPTION, _PERCEPTION, -1.0, 1.0), -1.0, 1.0)
            ny = torch.clamp(lmap(py, -_LANE_WIDTH * lanes, _LANE_WIDTH * lanes, -1.0, 1.0),
                             -1.0, 1.0)
            nvx = torch.clamp(lmap(pvx, -2 * _MAX_SPEED, 2 * _MAX_SPEED, -1.0, 1.0), -1.0, 1.0)
            nvy = torch.clamp(lmap(pvy, -2 * _MAX_SPEED, 2 * _MAX_SPEED, -1.0, 1.0), -1.0, 1.0)
            return nx, ny, nvx, nvy

        dx = x - x[:, :1]
        dy = y - y[:, :1]
        dist = torch.sqrt(dx * dx + dy * dy)
        close = (dist < _PERCEPTION) & (dx > -2.0 * _LENGTH)
        close[:, 0] = False
        order = torch.argsort(torch.where(close, dx.abs(), float("inf")), dim=-1, stable=True)
        sel = order[:, : f - 1]
        sel_ok = close.gather(1, sel)

        ego = torch.stack([torch.ones_like(x[:, 0]), *norm_row(x[:, 0], y[:, 0], vx[:, 0],
                                                                vy[:, 0])], -1)
        rel = norm_row(dx.gather(1, sel), dy.gather(1, sel), vx.gather(1, sel) - vx[:, :1],
                       vy.gather(1, sel) - vy[:, :1])
        rows = torch.stack([sel_ok.to(torch.float32), *rel], -1)
        rows = torch.where(sel_ok[..., None], rows, 0.0)
        return {
            "obs": torch.cat([ego[:, None], rows], 1),
            "info:speed": st["speed"][:, 0],
            "info:crashed": st["crashed"][:, 0],
        }
