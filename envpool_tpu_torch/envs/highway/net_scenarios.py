"""The highway family's lane-network scenarios: Merge, Exit, TwoWay, UTurn,
Roundabout, Intersection (discrete, continuous, two players) and the three
racetracks, batched in PyTorch.

Counterpart of ``envpool_tpu/envs/highway/net_scenarios.py`` (reference:
``envpool/highway/official_task.cc``, ``native_task_env.h``,
``official_observation.cc``).  The scenario builders and
:func:`_pack_scenario` are the JAX package's numpy code, copied; the env
holds ``[N, V]`` vehicles over the static :class:`LaneTable` and steps
them in a Python loop over substeps, each one :func:`network.lane_frame`
of every vehicle in every lane followed by gathers.

The JAX env's documented deviations carry over: traffic decisions are
taken synchronously from the state before each substep; the regulated
intersection predicts conflicts from straight constant-velocity
extrapolation; and for ``Intersection-v1`` the MDP autopilot overrides the
continuous action (an IDLE meta-action), as the reference's
``Road::Act`` does.
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
from . import network as net
from .network import (
    K_IDM, K_MDP, K_OBSTACLE, K_PLAIN, LANE_W, MAX_SPEED, MIN_SPEED, PERCEPTION, VEH_LEN,
    VEH_WID, LaneTable, RoadBuilder, f32, lmap, notzero, wrap_pi,
)

_PI = math.pi


# ---------------------------------------------------------------------------
# Scenario builders (numpy; copied from the JAX package)
# ---------------------------------------------------------------------------


def _veh(kind, lane, s, speed, target_speed=None, dest=None, enable_lc=True,
         dist_wanted=10.0, cmf_max=3.0, cmf_min=-5.0, length=VEH_LEN,
         width=VEH_WID, s_noise=(0.0, 0.0), v_noise=(0.0, 0.0), lat=0.0,
         heading=None, pos=None):
    return dict(kind=kind, lane=lane, s=s, speed=speed,
                target_speed=speed if target_speed is None else target_speed,
                dest=dest, enable_lc=enable_lc, dist_wanted=dist_wanted,
                cmf_max=cmf_max, cmf_min=cmf_min, length=length, width=width,
                s_noise=s_noise, v_noise=v_noise, lat=lat, heading=heading,
                pos=pos)


def _build_merge():
    """official_task.cc:126-192 (MakeMergeRoad / ResetMergeVehicles)."""
    b = RoadBuilder()
    ends = [150.0, 80.0, 80.0, 150.0]
    for lane in range(2):
        y = lane * LANE_W
        b.straight("a", "b", (0, y), (230, y))
        b.straight("b", "c", (230, y), (310, y))
        b.straight("c", "d", (310, y), (460, y))
    amp = 3.25
    b.straight("j", "k", (0, 14.5), (150, 14.5), forbidden=True)
    w = 2 * _PI / (2 * ends[1])
    # lkb: sine from ljk.Position(150,-amp) to ljk.Position(230,-amp)
    b.sine("k", "b", (150, 14.5 - amp), (230, 14.5 - amp), amp, w, _PI / 2,
           forbidden=True)
    lbc_start = b._np_position(len(b._lanes) - 1, 80.0, 0.0)
    b.straight("b", "c", tuple(lbc_start), (lbc_start[0] + 80, lbc_start[1]),
               forbidden=True)
    obstacle_pos = (lbc_start[0] + 80, lbc_start[1])
    lane_ab1 = b._edges[("a", "b")][1]
    lane_jk = b._edges[("j", "k")][0]
    vehicles = [
        _veh(K_MDP, lane_ab1, 30.0, 30.0, 30.0),
        _veh(K_IDM, lane_ab1, 90.0, 29.0, s_noise=(-5, 5), v_noise=(-1, 1)),
        _veh(K_IDM, lane_ab1, 70.0, 31.0, s_noise=(-5, 5), v_noise=(-1, 1)),
        _veh(K_IDM, lane_ab1, 5.0, 31.5, s_noise=(-5, 5), v_noise=(-1, 1)),
        _veh(K_IDM, lane_jk, 110.0, 20.0, 30.0),
        _veh(K_OBSTACLE, 0, 0.0, 0.0, length=2.0, width=2.0,
             pos=obstacle_pos),
    ]
    return b, vehicles, dict(ego_target_speeds=(20.0, 25.0, 30.0),
                             ego_speed_index=2,
                             merge_lane=b._edges[("b", "c")][2])


def _build_two_way():
    """official_task.cc:336-386."""
    b = RoadBuilder()
    b.straight("a", "b", (0, 0), (800, 0))
    b.straight("a", "b", (0, LANE_W), (800, LANE_W))
    b.straight("b", "a", (800, 0), (0, 0))
    ab1 = b._edges[("a", "b")][1]
    ba0 = b._edges[("b", "a")][0]
    vehicles = [_veh(K_MDP, ab1, 30.0, 30.0, 30.0)]
    for i in range(3):
        vehicles.append(_veh(K_IDM, ab1, 70.0 + 40.0 * i, 24.0,
                             enable_lc=False))
    for i in range(2):
        vehicles.append(_veh(K_IDM, ba0, 200.0 + 100.0 * i, 20.0,
                             enable_lc=False))
    return b, vehicles, dict(ego_target_speeds=(20.0, 25.0, 30.0),
                             ego_speed_index=2)


def _build_u_turn():
    """official_task.cc:388-466."""
    b = RoadBuilder()
    length, radius = 128.0, 20.0
    center = (length, LANE_W + 20.0)
    b.straight("c", "d", (length, LANE_W), (0, LANE_W))
    b.straight("c", "d", (length, 0), (0, 0))
    for lane in range(2):
        b.circular("b", "c", center, radius + lane * LANE_W, _PI / 2,
                   -_PI / 2, False)
    y0 = 2 * LANE_W + 2 * radius - LANE_W
    b.straight("a", "b", (0, y0), (length, y0))
    b.straight("a", "b", (0, y0 + LANE_W), (length, y0 + LANE_W))
    ab, bc, cd = b._edges[("a", "b")], b._edges[("b", "c")], b._edges[("c", "d")]
    vehicles = [
        _veh(K_MDP, ab[0], 0.0, 16.0, 16.0, dest="d"),
        _veh(K_IDM, ab[0], 25.0, 13.5, dest="d"),
        _veh(K_IDM, ab[1], 56.0, 14.5, dest="d"),
        _veh(K_IDM, bc[1], 0.5, 4.5, dest="d"),
        _veh(K_IDM, bc[0], 17.5, 5.5, dest="d"),
        _veh(K_IDM, cd[0], 1.0, 3.5, dest="d"),
        _veh(K_IDM, cd[1], 30.0, 5.5, dest="d"),
    ]
    return b, vehicles, dict(ego_target_speeds=(8.0, 16.0, 24.0),
                             ego_speed_index=1)


def _build_exit():
    """official_task.cc:533-611."""
    b = RoadBuilder()
    exit_pos, exit_len, road_len = 400.0, 100.0, 1000.0

    def slimit(lane):
        return 26.0 - 3.4 * lane

    for seg, (x0, x1, lanes) in (("01", (0.0, exit_pos, 6)),
                                 ("12", (exit_pos, exit_pos + exit_len, 7)),
                                 ("23", (exit_pos + exit_len, road_len, 6))):
        for lane in range(lanes):
            y = lane * LANE_W
            b.straight(seg[0], seg[1], (x0, y), (x1, y),
                       speed_limit=slimit(lane))
    radius = 150.0
    exit_start = (exit_pos + exit_len, 6 * LANE_W)
    b.circular("2", "exit", (exit_start[0], exit_start[1] + radius), radius,
               3 * _PI / 2, 2 * _PI, True, forbidden=True)
    l01 = b._edges[("0", "1")]
    vehicles = [_veh(K_MDP, l01[0], 30.0, 25.0, 24.0)]
    for i in range(20):
        lane = 1 + (i % 5)
        vehicles.append(_veh(K_IDM, l01[lane], 45.0 + 18.0 * i, slimit(lane),
                             enable_lc=False, dest="3"))
    return b, vehicles, dict(
        ego_target_speeds=(18.0, 24.0, 30.0), ego_speed_index=1,
        exit_pre_lane=b._edges[("1", "2")][6],
        success_lanes=(b._edges[("1", "2")][6], b._edges[("2", "exit")][0]))


def _build_roundabout():
    """official_task.cc:196-340."""
    b = RoadBuilder()
    radius, alpha = 20.0, 24.0 * _PI / 180.0
    ring = [("se", "ex", _PI / 2 - alpha, alpha),
            ("ex", "ee", alpha, -alpha),
            ("ee", "nx", -alpha, -_PI / 2 + alpha),
            ("nx", "ne", -_PI / 2 + alpha, -_PI / 2 - alpha),
            ("ne", "wx", -_PI / 2 - alpha, -_PI + alpha),
            ("wx", "we", -_PI + alpha, -_PI - alpha),
            ("we", "sx", _PI - alpha, _PI / 2 + alpha),
            ("sx", "se", _PI / 2 + alpha, _PI / 2 - alpha)]
    for lane in range(2):
        for f, t, p0, p1 in ring:
            b.circular(f, t, (0, 0), radius + 4.0 * lane, p0, p1, False)
    access, dev, a = 170.0, 85.0, 5.0
    d_st = 0.2 * dev
    d_en = dev - d_st
    w = 2 * _PI / dev
    for (pre, mid, node, xnode, post,
         entry_s, entry_e, exit_s, exit_e) in (
            ("ser", "ses", "se", "sx", "sxr",
             ((2, access), (2, dev / 2)),
             ((2 + a, dev / 2), (2 + a, dev / 2 - d_st)),
             ((-2 - a, -dev / 2 + d_en), (-2 - a, dev / 2)),
             ((-2, dev / 2), (-2, access))),
            ("eer", "ees", "ee", "ex", "exr",
             ((access, -2), (dev / 2, -2)),
             ((dev / 2, -2 - a), (dev / 2 - d_st, -2 - a)),
             ((-dev / 2 + d_en, 2 + a), (dev / 2, 2 + a)),
             ((dev / 2, 2), (access, 2))),
            ("ner", "nes", "ne", "nx", "nxr",
             ((-2, -access), (-2, -dev / 2)),
             ((-2 - a, -dev / 2), (-2 - a, -dev / 2 + d_st)),
             ((2 + a, dev / 2 - d_en), (2 + a, -dev / 2)),
             ((2, -dev / 2), (2, -access))),
            ("wer", "wes", "we", "wx", "wxr",
             ((-access, 2), (-dev / 2, 2)),
             ((-dev / 2, 2 + a), (-dev / 2 + d_st, 2 + a)),
             ((dev / 2 - d_en, -2 - a), (-dev / 2, -2 - a)),
             ((-dev / 2, -2), (-access, -2)))):
        b.straight(pre, mid, entry_s[0], entry_s[1])
        b.sine(mid, node, entry_e[0], entry_e[1], a, w, -_PI / 2)
        b.sine(xnode, xnode + "s", exit_s[0], exit_s[1], a, w,
               -_PI / 2 + w * d_en)
        b.straight(xnode + "s", post, exit_e[0], exit_e[1])
    ser = b._edges[("ser", "ses")][0]
    wesx = b._edges[("we", "sx")]
    eer = b._edges[("eer", "ees")][0]
    vehicles = [
        _veh(K_MDP, ser, 125.0, 8.0, 8.0, dest="nxs"),
        _veh(K_IDM, wesx[1], 5.0, 16.0, dest="nxr"),
        _veh(K_IDM, wesx[0], 20.0, 16.0, dest="sxr"),
        _veh(K_IDM, wesx[0], -20.0, 16.0, dest="exr"),
        _veh(K_IDM, eer, 50.0, 16.0, dest="nxr"),
    ]
    return b, vehicles, dict(ego_target_speeds=(0.0, 8.0, 16.0),
                             ego_speed_index=1)


def _rot(p, angle):
    c, s = math.cos(angle), math.sin(angle)
    return (c * p[0] + s * p[1], -s * p[0] + c * p[1])


def _build_intersection(multi=False):
    """official_task.cc:613-744 (MakeIntersectionRoad + resets)."""
    b = RoadBuilder()
    lw = LANE_W
    rtr = lw + 5.0
    ltr = rtr + lw
    outer = rtr + lw / 2.0
    access = 100.0
    for corner in range(4):
        angle = _PI / 2 * corner
        prio = 3 if corner % 2 else 1
        c, pc, lc, sc = (str(corner), str((corner + 3) % 4),
                         str((corner + 1) % 4), str((corner + 2) % 4))
        b.straight("o" + c, "ir" + c, _rot((lw / 2, access + outer), angle),
                   _rot((lw / 2, outer), angle), speed_limit=10.0,
                   priority=prio)
        b.circular("ir" + c, "il" + pc, _rot((outer, outer), angle), rtr,
                   angle + _PI, angle + 3 * _PI / 2, True, speed_limit=10.0,
                   priority=prio)
        b.circular("ir" + c, "il" + lc,
                   _rot((-ltr + lw / 2, ltr - lw / 2), angle), ltr, angle,
                   angle - _PI / 2, False, speed_limit=10.0,
                   priority=prio - 1)
        b.straight("ir" + c, "il" + sc, _rot((lw / 2, outer), angle),
                   _rot((lw / 2, -outer), angle), speed_limit=10.0,
                   priority=prio)
        b.straight("il" + pc, "o" + pc, _rot((outer, lw / 2), angle),
                   _rot((access + outer, lw / 2), angle), speed_limit=10.0,
                   priority=prio)

    def idm(incoming, s, speed, dest):
        lane = b._edges[("o%d" % incoming, "ir%d" % incoming)][0]
        return _veh(K_IDM, lane, s, speed, dest=dest, dist_wanted=7.0,
                    cmf_max=6.0, cmf_min=-3.0)

    if multi:
        e0 = b._edges[("o0", "ir0")][0]
        e1 = b._edges[("o1", "ir1")][0]
        vehicles = [
            _veh(K_MDP, e0, 65.0, 10.0, 20.0, dest="o1"),
            _veh(K_MDP, e1, 66.0, 10.0, 20.0, dest="o1"),
            idm(2, 55.0, 8.5, "o0"),
            idm(3, 70.0, 7.5, "o1"),
        ]
        extras = dict(ego_target_speeds=(0.0, 4.5, 9.0), ego_speed_index=0,
                      n_players=2)
    else:
        e0 = b._edges[("o0", "ir0")][0]
        vehicles = [
            _veh(K_MDP, e0, 65.0, 10.0, 9.0, dest="o1"),
            idm(1, 32.0, 8.0, "o3"),
            idm(2, 44.0, 8.5, "o0"),
            idm(3, 56.0, 7.5, "o1"),
            idm(0, 85.0, 8.0, "o2"),
            idm(1, 74.0, 8.0, "o2"),
        ]
        extras = dict(ego_target_speeds=(0.0, 4.5, 9.0), ego_speed_index=2)
    extras["regulated"] = True
    # arrival lanes: il* -> o*
    arrived = np.zeros(len(b._lanes), bool)
    for (f, t), ids in b._edges.items():
        if f.startswith("il") and t.startswith("o"):
            for k in ids:
                arrived[k] = True
    extras["arrival_lanes"] = arrived
    return b, vehicles, extras


def _build_racetrack(variant):
    """official_task.cc:776-893."""
    b = RoadBuilder()
    lanes = 3 if variant in ("racetrack_large", "racetrack_oval") else 2
    start_x = 0.0 if variant == "racetrack_oval" else 42.0
    end_x = {"racetrack": 100.0, "racetrack_large": 200.0,
             "racetrack_oval": 101.0}[variant]
    width = 5.0
    for lane in range(lanes):
        b.straight("a", "b", (start_x, lane * width), (end_x, lane * width),
                   width=width, speed_limit=10.0)
    c1 = (200.0, -20.0) if variant == "racetrack_large" else (100.0, -20.0)
    end_phase = 0.0 if variant == "racetrack_oval" else -_PI / 180.0
    for lane in range(lanes):
        b.circular("b", "c", c1, 20.0 + lane * width, _PI / 2, end_phase,
                   False, width=width, speed_limit=10.0)
    if variant == "racetrack":
        d = _PI / 180.0
        b.straight("c", "d", (120, -20), (120, -30), width=width,
                   speed_limit=10.0)
        b.straight("c", "d", (125, -20), (125, -30), width=width,
                   speed_limit=10.0)
        b.circular("d", "e", (105, -30), 15.0, 0.0, -181 * d, False,
                   width=width, speed_limit=10.0)
        b.circular("d", "e", (105, -30), 20.0, 0.0, -181 * d, False,
                   width=width, speed_limit=10.0)
        b.circular("e", "f", (70, -30), 20.0, 0.0, 136 * d, True,
                   width=width, speed_limit=10.0)
        b.circular("e", "f", (70, -30), 15.0, 0.0, 137 * d, True,
                   width=width, speed_limit=10.0)
        b.straight("f", "g", (55.7, -15.7), (35.7, -35.7), width=width,
                   speed_limit=10.0)
        b.straight("f", "g", (59.3934, -19.2), (39.3934, -39.2), width=width,
                   speed_limit=10.0)
        b.circular("g", "h", (18.1, -18.1), 25.0, 315 * d, 170 * d, False,
                   width=width, speed_limit=10.0)
        b.circular("g", "h", (18.1, -18.1), 30.0, 315 * d, 165 * d, False,
                   width=width, speed_limit=10.0)
        b.circular("h", "i", (18.1, -18.1), 25.0, 170 * d, 56 * d, False,
                   width=width, speed_limit=10.0)
        b.circular("h", "i", (18.1, -18.1), 30.0, 170 * d, 58 * d, False,
                   width=width, speed_limit=10.0)
        b.circular("i", "a", (43.2, 23.4), 23.5, 240 * d, 270 * d, True,
                   width=width, speed_limit=10.0)
        b.circular("i", "a", (43.2, 23.4), 18.5, 238 * d, 268 * d, True,
                   width=width, speed_limit=10.0)
    s0 = {"racetrack": 48.0, "racetrack_oval": 50.0,
          "racetrack_large": 80.0}[variant]
    vehicles = [_veh(K_PLAIN, b._edges[("a", "b")][0], s0, 10.0)]
    return b, vehicles, dict(ego_target_speeds=(20.0, 25.0, 30.0),
                             ego_speed_index=0)


_BUILDERS = {
    "merge": _build_merge,
    "two_way": _build_two_way,
    "u_turn": _build_u_turn,
    "exit": _build_exit,
    "roundabout": _build_roundabout,
    "intersection": _build_intersection,
    "intersection_multi": lambda: _build_intersection(multi=True),
    "racetrack": lambda: _build_racetrack("racetrack"),
    "racetrack_large": lambda: _build_racetrack("racetrack_large"),
    "racetrack_oval": lambda: _build_racetrack("racetrack_oval"),
}

_STATIC_CACHE: dict[str, tuple] = {}


def _pack_scenario(name):
    """Build lane + vehicle tables once per scenario (numpy)."""
    if name in _STATIC_CACHE:
        return _STATIC_CACHE[name]
    b, vehicles, extras = _BUILDERS[name]()
    T = b.lane_table()
    K = len(b._lanes)
    V = len(vehicles)
    veh = {
        "kind": np.array([v["kind"] for v in vehicles], np.int32),
        "lane": np.array([v["lane"] for v in vehicles], np.int32),
        "s": np.array([v["s"] for v in vehicles]),
        "speed": np.array([v["speed"] for v in vehicles]),
        "tspeed": np.array([v["target_speed"] for v in vehicles]),
        "enable_lc": np.array([v["enable_lc"] for v in vehicles], bool),
        "dist_wanted": np.array([v["dist_wanted"] for v in vehicles]),
        "cmf_max": np.array([v["cmf_max"] for v in vehicles]),
        "cmf_min": np.array([v["cmf_min"] for v in vehicles]),
        "length": np.array([v["length"] for v in vehicles]),
        "width": np.array([v["width"] for v in vehicles]),
        "s_noise": np.array([v["s_noise"] for v in vehicles]),
        "v_noise": np.array([v["v_noise"] for v in vehicles]),
    }
    # Initial poses.
    pos = np.zeros((V, 2))
    heading = np.zeros(V)
    for i, v in enumerate(vehicles):
        if v["pos"] is not None:
            pos[i] = v["pos"]
        else:
            pos[i] = b._np_position(v["lane"], v["s"], v["lat"])
            heading[i] = (v["heading"] if v["heading"] is not None
                          else b._np_heading(v["lane"], v["s"]))
    veh["pos0"] = pos
    veh["heading0"] = heading
    # Per-vehicle successor table next_of[V, K] (route-aware).
    next_of = np.zeros((V, K), np.int32)
    for i, v in enumerate(vehicles):
        for k in range(K):
            if v["dest"] is not None:
                next_of[i, k] = b.route_next(k, v["dest"])
            else:
                next_of[i, k] = b.default_next(k)
    veh["next_of"] = next_of
    _STATIC_CACHE[name] = (T, veh, extras)
    return _STATIC_CACHE[name]


# ---------------------------------------------------------------------------
# The generic network env
# ---------------------------------------------------------------------------


class NetworkScenarioEnv(TorchEnv):
    """Base env driving one lane-network scenario (native_task_env.h:552)."""

    SCENARIO = "merge"
    ACTION_MODE = "discrete5"  # discrete5 | discrete3 | multi3 | continuous2 | steer
    EGO_ROWS = (0,)
    DEFAULT_CONFIG: dict[str, Any] = {
        "duration": 40,
        "simulation_frequency": 15,
        "policy_frequency": 1,
        "reward_threshold": 0.0,
    }

    def __init__(self, config):
        super().__init__(config)
        tab, veh, extras = _pack_scenario(self.SCENARIO)
        dev = self.device
        self.T = LaneTable(tab, dev)
        self.extras = extras
        self.V = int(veh["kind"].shape[0])

        def f(x):
            return torch.as_tensor(np.asarray(x).astype(np.float32), device=dev)

        def i(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=dev)

        kind = np.asarray(veh["kind"])
        self.veh = {
            "lane": i(veh["lane"]), "s": f(veh["s"]),
            "speed": f(veh["speed"]), "tspeed": f(veh["tspeed"]),
            "dist_wanted": f(veh["dist_wanted"]), "cmf_max": f(veh["cmf_max"]),
            "length": f(veh["length"]),
            "width": f(veh["width"]), "pos0": f(veh["pos0"]),
            "heading0": f(veh["heading0"]), "s_noise": f(veh["s_noise"]),
            "v_noise": f(veh["v_noise"]),
            "next_of": torch.as_tensor(np.asarray(veh["next_of"], np.int64), device=dev),
        }
        v = self.V
        self._eye = torch.eye(v, dtype=torch.bool, device=dev)
        self._rows = torch.arange(v, device=dev)
        self._is_idm = torch.as_tensor(kind == K_IDM, device=dev)
        self._mdp = torch.as_tensor(kind == K_MDP, device=dev)
        self._moving = torch.as_tensor(kind != K_OBSTACLE, device=dev)
        self._lc = torch.as_tensor(np.asarray(veh["enable_lc"], bool), device=dev)
        # 2 * sqrt(-cmf_max * cmf_min) per row, in float32
        ab = -np.asarray(veh["cmf_max"], np.float32) * np.asarray(veh["cmf_min"], np.float32)
        self._gap_div = f(np.float32(2.0) * np.sqrt(ab.astype(np.float32)))
        self._noisy = torch.as_tensor(np.abs(np.asarray(veh["s_noise"])).sum(-1) > 0,
                                      device=dev)

    @property
    def _n_frames(self):
        return max(1, int(self.config["simulation_frequency"])
                   // int(self.config["policy_frequency"]))

    # -- specs --

    def action_spec(self):
        if self.ACTION_MODE == "discrete5":
            return {"action": ArraySpec(np.int32, (), 0, 4, is_discrete=True)}
        if self.ACTION_MODE == "discrete3":
            return {"action": ArraySpec(np.int32, (), 0, 2, is_discrete=True)}
        if self.ACTION_MODE == "multi3":
            return {"action": ArraySpec(np.int32, (-1,), 0, 2, is_discrete=True)}
        if self.ACTION_MODE == "continuous2":
            return {"action": ArraySpec(np.float32, (2,), -1.0, 1.0)}
        return {"action": ArraySpec(np.float32, (1,), -1.0, 1.0)}

    # -- reset --

    def plan_reset(self, d):
        """The reset's draws, in the JAX env's order (``reset_env``)."""
        d.uniform("u_s", (self.V,))
        d.uniform("u_v", (self.V,))

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    def reset_env(self, draws):
        veh, T = self.veh, self.T
        u_s, u_v = draws["u_s"], draws["u_v"]
        n = u_s.shape[0]
        sn, vn = veh["s_noise"], veh["v_noise"]
        # lo + u * (hi - lo), contracted to one fused multiply-add by XLA
        # (exact in float64, then rounded once)
        ds = (sn[:, 0].double() + u_s.double() * (sn[:, 1] - sn[:, 0]).double()).float()
        dv = (vn[:, 0].double() + u_v.double() * (vn[:, 1] - vn[:, 0]).double()).float()
        s0 = veh["s"] + ds
        lane = veh["lane"].expand(n, -1)
        pos = torch.where(self._noisy[:, None],
                          net.lane_position(T, lane, s0, torch.zeros_like(s0)),
                          veh["pos0"])
        zeros_v = torch.zeros((n, self.V), dtype=torch.bool, device=u_s.device)
        extras = self.extras
        st = {
            "pos": pos,
            "heading": veh["heading0"].expand(n, -1).clone(),
            "speed": veh["speed"] + dv,
            "lane": lane.clone(),
            "target_lane": lane.clone(),
            "target_speed": veh["tspeed"].expand(n, -1).clone(),
            "speed_index": torch.full((n,), int(extras["ego_speed_index"]), dtype=torch.int32,
                                      device=u_s.device),
            "timer": mod((pos[..., 0] + pos[..., 1]) * f32(_PI), 1.0),
            "crashed": zeros_v,
            "yielding": zeros_v.clone(),
            "last_action": torch.ones((n,), dtype=torch.int32, device=u_s.device),
            "last_steer": torch.zeros((n,), device=u_s.device),
            "reg_count": torch.full((n,), 45 if extras.get("regulated") else 0,
                                    dtype=torch.int32, device=u_s.device),
            "act_lowlevel": torch.zeros((n, 2), device=u_s.device),
        }
        return st, self._obs(st, net.lane_frame(T, pos))

    # -- shared machinery --

    @staticmethod
    def _dirs(st):
        return net.cos(st["heading"]), net.sin(st["heading"])

    def _neighbors(self, frame, s_self, q_lane):
        """front/rear ``[N, Q, V]`` of every row in its query lanes ``q_lane``
        ``[N, Q, V]`` (every other vehicle projected into that lane's frame;
        RoadNeighbors, official_scene.cc:287-326); ``s_self`` is each row's
        own longitudinal position there."""
        s_all, lat_all = net.frame_pairs(frame, q_lane)
        q = q_lane.long()[..., None]
        width = self.T.col("width")[q]
        ln = self.T.col("length")[q]
        ok = ((lat_all.abs() <= width / 2.0 + 1.0) & (s_all >= -VEH_LEN)
              & (s_all < ln + VEH_LEN) & ~self._eye)
        front_mask = ok & (s_all >= s_self[..., None])
        rear_mask = ok & (s_all < s_self[..., None])
        front_idx = torch.where(front_mask, s_all, float("inf")).argmin(-1)
        rear_idx = torch.where(rear_mask, s_all, float("-inf")).argmax(-1)
        return front_idx, front_mask.any(-1), rear_idx, rear_mask.any(-1)

    def _fields(self, st):
        """``[N, V, 6]``: speed, target speed, vx, vy and the heading's
        cosine and sine of every row, for gathers by row."""
        c, s = self._dirs(st)
        spd = st["speed"]
        return torch.stack([spd, st["target_speed"], spd * c, spd * s, c, s], -1)

    @staticmethod
    def _rows_of(fields, idx):
        """The fields of rows ``idx`` ``[N, Q, V]``: ``[N, Q, V, F]``."""
        n, q, v = idx.shape
        flat = idx.long().reshape(n, q * v, 1).expand(n, q * v, fields.shape[-1])
        return fields.gather(1, flat).reshape(n, q, v, -1)

    def _idm(self, frame, fields, ego, ego_valid, front, front_valid, ego_lane):
        """IDM acceleration ``[N, Q, V]`` of row ``ego`` (None: each row)
        following row ``front`` in lane ``ego_lane`` (all ``[N, Q, V]``;
        official_scene.cc:335-362, ``_idm_pair`` of the JAX env, one
        elementwise program for all queries); target speed clipped to that
        lane's speed limit."""
        veh = self.veh
        n, q, v = front.shape
        if ego is None:
            e = self._rows.expand(n, q, v)
            spd, tspd, vx, vy, c, s = fields[:, None].unbind(-1)
            cmf_max = veh["cmf_max"]
            dist_wanted, gap_div = veh["dist_wanted"], self._gap_div
        else:
            e = ego.long()
            spd, tspd, vx, vy, c, s = self._rows_of(fields, e).unbind(-1)
            cmf_max = veh["cmf_max"][e]
            dist_wanted, gap_div = veh["dist_wanted"][e], self._gap_div[e]
        _, _, fvx, fvy, _, _ = self._rows_of(fields, front).unbind(-1)
        tspd = torch.minimum(torch.clamp_min(tspd, 0.0),
                             self.T.col("speed_limit")[ego_lane.long()])
        acc = cmf_max * (1.0 - net.pow(torch.clamp_min(spd, 0.0) / notzero(tspd).abs(), 4.0))
        s_f, _ = net.frame_at(frame, ego_lane, front)
        s_e, _ = net.frame_at(frame, ego_lane, e)
        d = s_f - s_e
        proj_dv = (vx - fvx) * c + (vy - fvy) * s
        gap = dist_wanted + spd * 1.5 + spd * proj_dv / gap_div
        r = gap / notzero(d)
        acc = acc - torch.where(front_valid, cmf_max * (r * r), 0.0)
        return acc if ego_valid is None else torch.where(ego_valid, acc, 0.0)

    def _meta(self, st, frame, a, tl, ts, si):
        """The MDP meta-action ``a`` ``[N, P]`` of the ego rows at the first
        frame (ActMDP): new target speeds and lanes, and the speed index."""
        T = self.T
        ego = list(self.EGO_ROWS)
        tspeeds = self.extras["ego_target_speeds"]
        idx = net.speed_to_index(tspeeds, st["speed"][:, ego])
        faster, slower = a == 3, a == 4
        idx2 = torch.clamp(idx + faster.to(torch.int32) - slower.to(torch.int32), 0,
                           len(tspeeds) - 1)
        change = faster | slower
        ts_ego = torch.where(change, const(tspeeds, ts.device)[idx2.long()], ts[:, ego])
        si = torch.where(change.any(1), idx2[:, 0], si)
        # LANE_LEFT / LANE_RIGHT on the segment of the target lane.
        tl_ego = tl[:, ego].long()
        delta = torch.where(a == 2, 1, torch.where(a == 0, -1, 0))
        cand_id = torch.minimum(torch.clamp_min(T.lane_id[tl_ego] + delta, 0),
                                T.seg_count[tl_ego] - 1)
        cand = T.seg_lane[tl_ego, cand_id.long()]
        s_c, lat_c = net.frame_at(frame, cand, self._rows[ego].expand_as(cand))
        reach = net.is_reachable(T, cand, s_c, lat_c)
        tl_ego = torch.where(((a == 0) | (a == 2)) & reach, cand, tl_ego.to(torch.int32))
        rest = slice(len(ego), None)
        return (torch.cat([tl_ego, tl[:, rest]], 1), torch.cat([ts_ego, ts[:, rest]], 1), si)

    def _substep(self, st, frame, dt, meta_action):
        """One simulation frame (Road::Act + Road::Step), from the
        :func:`network.lane_frame` of the positions; returns the new state
        and the frame of its positions."""
        T, veh = self.T, self.veh
        is_idm = self._is_idm & ~st["crashed"]
        fr = is_idm | self._mdp
        tl, ts, si = st["target_lane"], st["target_speed"], st["speed_index"]
        if meta_action is not None:
            tl, ts, si = self._meta(st, frame, meta_action, tl, ts, si)

        # --- FollowRoad (MDP + IDM) ---
        s_tl, _ = net.frame_at(frame, tl)
        adv = fr & net.after_end(T, tl, s_tl)
        tl = torch.where(adv, veh["next_of"][self._rows, tl.long()].to(torch.int32), tl)

        # --- IDM lane-change policy (ChangeLanePolicy) ---
        lane = st["lane"]
        same_seg = T.seg_idx[lane.long()] == T.seg_idx[tl.long()]
        changing = lane != tl
        # Abort: someone else is merging into my target lane too close ahead
        # (official_scene.cc:559-578).
        s_t, _ = net.frame_pairs(frame, lane)
        s_self, _ = net.frame_at(frame, lane)
        d_others = s_t - s_self[..., None]
        fields = self._fields(st)
        spd, _, vx, vy, c, s = fields.unbind(-1)
        proj_dv = ((vx[:, :, None] - vx[:, None, :]) * c[:, :, None]
                   + (vy[:, :, None] - vy[:, None, :]) * s[:, :, None])
        gap = (veh["dist_wanted"][:, None] + spd[:, :, None] * 1.5
               + spd[:, :, None] * proj_dv / self._gap_div[:, None])
        conflict = ((lane[:, None, :] != tl[:, :, None])
                    & (st["target_lane"][:, None, :] == tl[:, :, None])
                    & ~self._eye & (d_others > 0.0) & (d_others < gap)).any(-1)
        abort = is_idm & changing & same_seg & conflict
        tl = torch.where(abort, lane, tl)

        may = is_idm & self._lc & ~changing & (st["timer"] > 1.0)
        timer = torch.where(may, 0.0, st["timer"])
        lane_l = lane.long()
        lane_id = T.lane_id[lane_l]
        left = T.seg_lane[lane_l, torch.clamp_min(lane_id - 1, 0).long()]
        right = T.seg_lane[lane_l, torch.minimum(lane_id + 1, T.seg_count[lane_l] - 1).long()]
        okspeed = st["speed"].abs() >= 1.0
        # MOBIL (politeness 0) to both side lanes in one program: the new
        # followers behind us (their own frame is the candidate lane), us
        # behind the new fronts, us behind the old front.
        fields = self._fields(dict(st, target_speed=ts))
        cands = torch.stack([left, right, lane], 1)
        s_q, lat_q = net.frame_at(frame, cands)
        nf, nfv, nr, nrv = self._neighbors(frame, s_q, cands)
        n, v = lane.shape
        rows = self._rows.expand(n, 2, v)
        ones = torch.ones_like(nrv)
        acc = self._idm(frame, fields, torch.cat([nr[:, :2], rows, rows[:, :1]], 1),
                        torch.cat([nrv[:, :2], ones], 1), torch.cat([rows, nf], 1),
                        torch.cat([ones[:, :2], nfv], 1), torch.cat([cands[:, :2], cands], 1))
        safe = ~nrv[:, :2] | (acc[:, :2] >= -2.0)
        gain = acc[:, 2:4] - acc[:, 4:5] >= f32(0.2)
        reach = net.is_reachable(T, cands[:, :2], s_q[:, :2], lat_q[:, :2])
        move = (may[:, None] & (cands[:, :2] != lane[:, None]) & okspeed[:, None] & reach
                & safe & gain)
        tl = torch.where(move[:, 0], left, tl)
        tl = torch.where(move[:, 1], right, tl)  # right wins if both (C++ loop order)

        st2 = dict(st, target_lane=tl, target_speed=ts, timer=timer)

        # --- controls ---
        s_tl, lat_tl = net.frame_at(frame, tl)
        steer = net.steering_control(T, tl, s_tl, lat_tl, st["heading"], st["speed"])
        # behind the front in the own lane: the MOBIL program's last query
        acc_idm = acc[:, 4]
        tfront, tfront_v, _, _ = self._neighbors(frame, s_tl[:, None], tl[:, None])
        acc_idm_t = self._idm(frame, fields, None, None, tfront, tfront_v, tl[:, None])[:, 0]
        acc_idm = torch.where(lane != tl, torch.minimum(acc_idm, acc_idm_t), acc_idm)
        acc_idm = torch.clamp(acc_idm, -6.0, 6.0)
        acc_mdp = f32(1.0 / 0.6) * (ts - st["speed"])
        acc = torch.where(is_idm, acc_idm, acc_mdp)
        if self.ACTION_MODE == "steer":  # plain-vehicle ego (racetrack)
            steer = torch.cat([st["act_lowlevel"][:, 1:2], steer[:, 1:]], 1)
            acc = torch.cat([st["act_lowlevel"][:, 0:1], acc[:, 1:]], 1)

        # crashed: decelerate (Vehicle::Step)
        crashed, speed = st["crashed"], st["speed"]
        steer = torch.where(crashed, 0.0, steer)
        acc = torch.where(crashed, -speed, acc)
        acc = torch.where(speed > MAX_SPEED, torch.minimum(acc, MAX_SPEED - speed), acc)
        acc = torch.where(speed < MIN_SPEED, torch.maximum(acc, MIN_SPEED - speed), acc)
        acc = torch.where(self._moving, acc, 0.0)

        # --- bicycle step ---
        beta = net.atan(0.5 * net.tan(steer))
        bh = st["heading"] + beta
        vx = speed * net.cos(bh)
        vy = speed * net.sin(bh)
        moving = self._moving.to(torch.float32)
        pos = st["pos"] + torch.stack([vx, vy], -1) * dt * moving[:, None]
        heading = st["heading"] + (speed * net.sin(beta) * f32(1.0 / (VEH_LEN / 2.0))
                                   * dt) * moving
        speed = speed + acc * dt

        crashed_now = net.collide(pos[..., 0], pos[..., 1], heading, vx, vy, veh["length"],
                                  veh["width"], dt, self._eye)
        crashed = crashed | (crashed_now & self._moving)
        new_frame = net.lane_frame(T, pos)
        new_lane = net.closest_lane(T, new_frame, heading)
        new_lane = torch.where(self._moving, new_lane, lane)
        timer = timer + dt * is_idm.to(torch.float32)

        out = dict(st2, pos=pos, heading=heading, speed=speed, lane=new_lane, crashed=crashed,
                   timer=timer, speed_index=si)

        # --- regulated intersection yielding ---
        if self.extras.get("regulated"):
            out = self._enforce_rules(out)
        return out, new_frame

    def _enforce_rules(self, st):
        """Priority yielding every 0.5 s (official_scene.cc:452-476), the
        conflicts predicted by straight constant-velocity extrapolation."""
        T = self.T
        cnt = st["reg_count"] + 1
        fire = ((cnt % 7) == 0)[:, None]
        c, s = self._dirs(st)
        spd = st["speed"]
        pos = st["pos"]
        times = const(tuple(0.25 * k for k in range(1, 12)), pos.device)[None, :, None]
        fx = pos[:, None, :, 0] + (spd * c)[:, None, :] * times      # [N, 11, V]
        fy = pos[:, None, :, 1] + (spd * s)[:, None, :] * times
        dx = fx[..., :, None] - fx[..., None, :]
        dy = fy[..., :, None] - fy[..., None, :]
        conflict = (torch.sqrt(dx * dx + dy * dy) < VEH_LEN).any(1) & ~self._eye
        prio = T.priority[st["lane"].long()]
        px, py = pos[..., 0], pos[..., 1]
        fwd = (c[:, :, None] * (px[:, None, :] - px[:, :, None])
               + s[:, :, None] * (py[:, None, :] - py[:, :, None]))
        i_yields = torch.where(prio[:, :, None] != prio[:, None, :],
                               prio[:, :, None] < prio[:, None, :], fwd > fwd.transpose(1, 2))
        yield_now = (conflict & i_yields).any(-1) & self._is_idm
        reset = st["yielding"] & ~yield_now
        ts = torch.where(fire & reset, T.col("speed_limit")[st["lane"].long()],
                         st["target_speed"])
        ts = torch.where(fire & yield_now, 0.0, ts)
        yielding = torch.where(fire, yield_now, st["yielding"])
        return dict(st, reg_count=cnt, target_speed=ts, yielding=yielding)

    # -- step --

    def step_env(self, state, action, draws):
        del draws
        dt = f32(1.0 / float(self.config["simulation_frequency"]))
        meta, st = self._read_action(state, action)
        frame = net.lane_frame(self.T, st["pos"])
        for i in range(self._n_frames):
            st, frame = self._substep(st, frame, dt, meta if i == 0 else None)
        return EnvOut(state=st, obs=self._obs(st, frame), reward=self._reward(st, frame),
                      terminated=self._terminated(st, frame))

    def _read_action(self, st, action):
        n = st["speed"].shape[0]
        if self.ACTION_MODE == "discrete5":
            a = torch.clamp(action.reshape(n).to(torch.int32), 0, 4)
            return a[:, None], dict(st, last_action=a)
        if self.ACTION_MODE in ("discrete3", "multi3"):
            a = torch.clamp(action.reshape(n, -1).to(torch.int32), 0, 2)
            # 0 -> SLOWER(4), 1 -> IDLE(1), 2 -> FASTER(3)
            a = torch.where(a == 0, 4, torch.where(a == 2, 3, 1)).to(torch.int32)
            return a, dict(st, last_action=a[:, 0])
        if self.ACTION_MODE == "continuous2":
            a = torch.clamp(action.reshape(n, 2), -1.0, 1.0)
            # Reference quirk: the MDP autopilot overrides the continuous
            # action (see the module docstring): an IDLE meta-action.
            idle = torch.ones((n, 1), dtype=torch.int32, device=a.device)
            return idle, dict(st, act_lowlevel=a, last_steer=a[:, 1].abs())
        a = torch.clamp(action.reshape(n, 1)[:, 0], -1.0, 1.0)
        steer = a * f32(_PI / 4.0)
        return None, dict(st, act_lowlevel=torch.stack([torch.zeros_like(steer), steer], -1),
                          last_steer=a.abs())

    # -- observations --

    def _obs(self, st, frame):
        raise NotImplementedError

    @staticmethod
    def _common_info(st):
        return {"info:speed": st["speed"][:, 0], "info:crashed": st["crashed"][:, 0]}

    def _kinematics(self, st, frame, rows, feats, absolute=False, normalize=True, clip=True,
                    include_obstacles=True, x_rng=(-200.0, 200.0), y_rng=None,
                    v_rng=(-80.0, 80.0), ego_x_override=None, observer=0):
        """ObserveKinematics (official_observation.cc:218-256): ``[N, rows,
        len(feats)]``."""
        T = self.T
        V = self.V
        o = observer
        pos = st["pos"]
        ego_lane = st["lane"][:, o]
        s_all, _ = net.frame_at(frame, ego_lane[:, None].expand(-1, V), self._rows.expand(
            pos.shape[0], -1))
        lane_dist = s_all - s_all[:, o:o + 1]
        dp = pos - pos[:, o:o + 1]
        euclid = torch.sqrt(dp[..., 0] * dp[..., 0] + dp[..., 1] * dp[..., 1])
        valid = (euclid < PERCEPTION) & (lane_dist > -2.0 * VEH_LEN) & (self._rows != o)
        if not include_obstacles:
            valid = valid & self._moving
        order = torch.argsort(torch.where(valid, lane_dist.abs(), float("inf")), dim=-1,
                              stable=True)
        c, s = self._dirs(st)
        vel_x, vel_y = st["speed"] * c, st["speed"] * s
        if y_rng is None:
            n_side = T.seg_count[ego_lane.long()].to(torch.float32)
            y_lo, y_hi = (-LANE_W * n_side)[:, None], (LANE_W * n_side)[:, None]
        else:
            y_lo, y_hi = y_rng

        def feature_rows(idx, rel):
            """``[N, Q, F]`` of the rows ``idx`` ``[N, Q]``."""
            def g(t):
                return t.gather(1, idx)

            table = {"presence": lambda: torch.ones(idx.shape, device=pos.device)}
            origin = {"x": pos[:, o:o + 1, 0], "y": pos[:, o:o + 1, 1],
                      "vx": vel_x[:, o:o + 1], "vy": vel_y[:, o:o + 1]}
            src = {"x": pos[..., 0], "y": pos[..., 1], "vx": vel_x, "vy": vel_y}
            out = []
            lo = None
            for f in feats:
                if f in src:
                    v = g(src[f])
                    if rel:
                        v = v - origin[f]
                    if normalize:
                        lo_hi = {"x": x_rng, "y": (y_lo, y_hi), "vx": v_rng, "vy": v_rng}[f]
                        v = lmap(v, lo_hi[0], lo_hi[1], -1, 1)
                        if clip:
                            v = torch.clamp(v, -1.0, 1.0)
                    out.append(v)
                elif f == "presence":
                    out.append(table["presence"]())
                elif f in ("cos_h", "sin_h"):
                    out.append(g(c if f == "cos_h" else s))
                else:
                    if lo is None:
                        own = g(st["lane"])
                        lo_s, lo_lat = net.frame_at(frame, own, idx)
                        ang = wrap_pi(g(st["heading"]) - net.lane_heading_at(T, own, lo_s))
                        lo = {"long_off": lo_s, "lat_off": lo_lat, "ang_off": ang}
                    out.append(lo[f])
            return torch.stack(out, -1)

        n = pos.shape[0]
        ego_feat = feature_rows(torch.full((n, 1), o, dtype=torch.long, device=pos.device),
                                rel=False)
        if ego_x_override is not None:
            k = torch.full((n, 1), int(ego_x_override), dtype=torch.int32, device=pos.device)
            ovr_s, _ = net.frame_at(frame, k, torch.full_like(k, o))
            x_n = lmap(ovr_s, x_rng[0], x_rng[1], -1, 1) if normalize else ovr_s
            i = feats.index("x")
            ego_feat = torch.cat([ego_feat[..., :i], x_n[..., None], ego_feat[..., i + 1:]], -1)
        other = feature_rows(order, rel=not absolute)
        other = torch.where(valid.gather(1, order)[..., None], other, 0.0)
        out = torch.cat([ego_feat, other[:, : rows - 1]], 1)
        pad = rows - out.shape[1]
        if pad > 0:
            out = torch.cat([out, out.new_zeros((n, pad, out.shape[2]))], 1)
        return out

    def _ttc(self, st, frame, horizon):
        """ObserveTimeToCollision (official_observation.cc:258-330): ``[N, 3,
        3, horizon]``."""
        T = self.T
        V = self.V
        n = st["pos"].shape[0]
        tspeeds = const(self.extras["ego_target_speeds"], st["pos"].device)
        ego_lane = st["lane"][:, 0]
        c, s = self._dirs(st)
        s_all, _ = net.frame_at(frame, ego_lane[:, None].expand(-1, V),
                                self._rows.expand(n, -1))
        lane_dist = s_all - s_all[:, :1]
        proj_speed = st["speed"] * c * c[:, :1] + st["speed"] * s * s[:, :1]
        lane = st["lane"].long()
        conn = T.conn_seg[T.seg_idx[ego_lane.long()][:, None], T.seg_idx[lane]]
        other = (self._rows != 0) & self._moving & conn
        ego_nlanes = T.seg_count[ego_lane.long()]
        same_count = T.seg_count[lane] == ego_nlanes[:, None]
        own_col = T.lane_id[lane]
        margins = const((0.0, -VEH_LEN, VEH_LEN), lane.device)
        costs = const((1.0, 0.5, 0.5), lane.device)
        # [N, speed, vehicle, margin]
        dists = lane_dist[:, None, :, None] + margins
        rel_v = tspeeds[None, :, None, None] - proj_speed[:, None, :, None]
        tti = dists / notzero(rel_v)
        ok = (tti >= 0.0) & other[:, None, :, None]
        cols = torch.arange(3, device=lane.device)
        col_hit = torch.where(same_count[:, None, :], cols[:, None] == own_col[:, None, :],
                              cols[None, :, None] < ego_nlanes[:, None, None])  # [N, 3, V]
        tq = f32(1.0 / float(self.config["policy_frequency"]))
        hs = torch.arange(horizon, device=lane.device)
        grid = torch.zeros((n, 3, 3, horizon), device=lane.device)
        for t_idx in (torch.floor(tti / tq), torch.ceil(tti / tq)):
            inrange = ok & (t_idx >= 0) & (t_idx < horizon)
            # cost where the (vehicle, margin) pair lands in (lane, time)
            land = (t_idx[..., None] == hs) & inrange[..., None]          # [N, s, V, m, H]
            val = torch.where(land, costs[:, None], 0.0)
            val = (val[:, :, None] * col_hit[:, None, :, :, None, None]).amax((3, 4))
            grid = torch.maximum(grid, val)
        return grid

    def _occupancy(self, st, frame):
        """Occupancy grid ``[N, 2, 12, 12]`` (native_task_env.h:1831-1881)."""
        T = self.T
        n = st["pos"].shape[0]
        ego_pos = st["pos"][:, 0]
        ego_h = st["heading"][:, 0]
        c, s = net.cos(ego_h), net.sin(ego_h)

        def cell(px, py):
            dx, dy = px - ego_pos[:, 0].reshape(-1, *([1] * (px.dim() - 1))), \
                py - ego_pos[:, 1].reshape(-1, *([1] * (py.dim() - 1)))
            cc = c.reshape(dx.shape[:1] + (1,) * (dx.dim() - 1))
            ss = s.reshape(dx.shape[:1] + (1,) * (dx.dim() - 1))
            ax = cc * dx + ss * dy
            ay = -ss * dx + cc * dy
            i = torch.floor((ax + 18.0) * f32(1.0 / 3.0))
            j = torch.floor((ay + 18.0) * f32(1.0 / 3.0))
            okc = (i >= 0) & (i < 12) & (j >= 0) & (j < 12)
            flat = (torch.clamp(i, 0, 11) * 12 + torch.clamp(j, 0, 11)).long()
            return flat.reshape(n, -1), okc.reshape(n, -1).to(torch.float32)

        grid = torch.zeros((n, 2, 144), device=ego_pos.device)
        flat, okc = cell(st["pos"][..., 0], st["pos"][..., 1])
        okc = okc * self._moving.to(torch.float32)
        grid[:, 0].scatter_reduce_(1, flat, okc, "amax")
        origin = frame[0][:, 0, :]                                          # [N, K]
        steps = const(tuple(float(v) for v in np.arange(-100.0, 100.0, 3.0, dtype=np.float32)),
                      ego_pos.device)
        wps = origin[..., None] + steps
        wps = torch.minimum(torch.clamp_min(wps, 0.0), T.col("length")[:, None])
        pts = net.lane_position(T, None, wps.transpose(1, 2), torch.zeros_like(wps).transpose(1, 2))
        flat, okc = cell(pts[..., 0], pts[..., 1])
        grid[:, 1].scatter_reduce_(1, flat, okc, "amax")
        return grid.reshape(n, 2, 12, 12)

    # -- per-scenario hooks --

    def _reward(self, st, frame):
        raise NotImplementedError

    def _terminated(self, st, frame):
        return st["crashed"][:, 0]

    def _on_road(self, st, frame, row=0):
        lane = st["lane"][:, row:row + 1]
        s, lat = net.frame_at(frame, lane, torch.full_like(lane, row))
        return net.on_lane(self.T, lane[:, 0], s[:, 0], lat[:, 0])
