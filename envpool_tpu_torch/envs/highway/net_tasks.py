"""The lane-network scenario envs: rewards, terminations and observations.

Counterpart of ``envpool_tpu/envs/highway/net_tasks.py`` (reference:
``envpool/highway/native_task_env.h``, ``OfficialReward`` (:1170-1264),
``OfficialIntersectionReward`` (:1266), ``OfficialRacetrackReward``
(:1292) and the per-scenario ``done_`` conditions (:918-925, :977-990)).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.specs import ArraySpec
from . import network as net
from .net_scenarios import NetworkScenarioEnv
from .network import lmap

_INF = float("inf")


def _kin_spec(rows, feats):
    return {
        "obs": ArraySpec(np.float32, (rows, feats), -_INF, _INF),
        "info:speed": ArraySpec(np.float32, ()),
        "info:crashed": ArraySpec(np.bool_, ()),
    }


def _f(b):
    return b.to(torch.float32)


class MergeEnv(NetworkScenarioEnv):
    """Merge-v0 (native_task_env.h:1245-1263)."""

    SCENARIO = "merge"
    ACTION_MODE = "discrete5"

    def state_spec(self):
        return _kin_spec(5, 5)

    def _obs(self, st, frame):
        obs = self._kinematics(st, frame, 5, ["presence", "x", "y", "vx", "vy"],
                               y_rng=(-8.0, 8.0))
        return {"obs": obs, **self._common_info(st)}

    def _reward(self, st, frame):
        T = self.T
        scaled = lmap(st["speed"][:, 0], 20.0, 30.0, 0.0, 1.0)
        on_ramp = (st["lane"] == int(self.extras["merge_lane"])) & self._moving
        ts = st["target_speed"]
        merging = torch.where(on_ramp, (ts - st["speed"]) / torch.where(ts != 0, ts, 1.0),
                              0.0).sum(-1)
        lc = (st["last_action"] == 0) | (st["last_action"] == 2)
        weighted = (-1.0 * _f(st["crashed"][:, 0])
                    + 0.1 * _f(T.lane_id[st["lane"][:, 0].long()])
                    + 0.2 * scaled - 0.05 * _f(lc) - 0.5 * merging)
        return lmap(weighted, -1.5, 0.3, 0.0, 1.0)

    def _terminated(self, st, frame):
        return st["crashed"][:, 0] | (st["pos"][:, 0, 0] > 370.0)


class TwoWayEnv(NetworkScenarioEnv):
    """TwoWay-v0, the time-to-collision observation (native_task_env.h:1191-1202)."""

    SCENARIO = "two_way"
    ACTION_MODE = "discrete5"
    HORIZON = 5

    def state_spec(self):
        return {
            "obs": ArraySpec(np.float32, (3, 3, self.HORIZON), 0.0, 1.0),
            "info:speed": ArraySpec(np.float32, ()),
            "info:crashed": ArraySpec(np.bool_, ()),
        }

    def _obs(self, st, frame):
        return {"obs": self._ttc(st, frame, self.HORIZON), **self._common_info(st)}

    def _reward(self, st, frame):
        T = self.T
        count = T.seg_count[st["lane"][:, 0].long()]
        n = torch.clamp_min(count - 1, 1)
        hs = _f(st["speed_index"]) * 0.5
        ll = _f(count - 1 - T.lane_id[st["target_lane"][:, 0].long()]) / _f(n)
        return 0.8 * hs + 0.2 * ll


class UTurnEnv(TwoWayEnv):
    """UTurn-v0 (native_task_env.h:1204-1218)."""

    SCENARIO = "u_turn"
    HORIZON = 16

    def _reward(self, st, frame):
        T = self.T
        lane0 = st["lane"][:, 0].long()
        n = _f(torch.clamp_min(T.seg_count[lane0] - 1, 1))
        lane_r = _f(T.lane_id[lane0]) / n
        speed_r = torch.clamp(lmap(st["speed"][:, 0], 8.0, 24.0, 0.0, 1.0), 0.0, 1.0)
        weighted = -1.0 * _f(st["crashed"][:, 0]) + 0.1 * lane_r + 0.4 * speed_r
        return lmap(weighted, -1.0, 0.5, 0.0, 1.0) * _f(self._on_road(st, frame))


class ExitEnv(NetworkScenarioEnv):
    """Exit-v0 (native_task_env.h:1236-1244)."""

    SCENARIO = "exit"
    ACTION_MODE = "discrete5"
    DEFAULT_CONFIG = dict(NetworkScenarioEnv.DEFAULT_CONFIG,
                          simulation_frequency=5, duration=18)

    def state_spec(self):
        return _kin_spec(15, 7)

    def _obs(self, st, frame):
        obs = self._kinematics(st, frame, 15,
                               ["presence", "x", "y", "vx", "vy", "cos_h", "sin_h"],
                               clip=False, y_rng=(-24.0, 24.0),
                               ego_x_override=self.extras["exit_pre_lane"])
        return {"obs": obs, **self._common_info(st)}

    def _reward(self, st, frame):
        s0, s1 = self.extras["success_lanes"]
        tl = st["target_lane"][:, 0]
        success = (tl == s0) | (tl == s1)
        scaled = torch.clamp(lmap(st["speed"][:, 0], 20.0, 30.0, 0.0, 1.0), 0.0, 1.0)
        return torch.clamp(_f(success) + 0.1 * scaled, 0.0, 1.0)


class RoundaboutEnv(NetworkScenarioEnv):
    """Roundabout-v0 (native_task_env.h:1220-1233)."""

    SCENARIO = "roundabout"
    ACTION_MODE = "discrete5"

    def state_spec(self):
        return _kin_spec(5, 5)

    def _obs(self, st, frame):
        obs = self._kinematics(st, frame, 5, ["presence", "x", "y", "vx", "vy"],
                               absolute=True, x_rng=(-100.0, 100.0), y_rng=(-100.0, 100.0),
                               v_rng=(-15.0, 15.0))
        return {"obs": obs, **self._common_info(st)}

    def _reward(self, st, frame):
        hs = _f(st["speed_index"]) * 0.5
        lc = (st["last_action"] == 0) | (st["last_action"] == 2)
        weighted = -1.0 * _f(st["crashed"][:, 0]) + 0.2 * hs - 0.05 * _f(lc)
        return lmap(weighted, -1.0, 0.2, 0.0, 1.0) * _f(self._on_road(st, frame))


class _IntersectionBase(NetworkScenarioEnv):
    SCENARIO = "intersection"

    def __init__(self, config):
        super().__init__(config)
        self._arrival = torch.as_tensor(np.asarray(self.extras["arrival_lanes"]),
                                        device=self.device)

    def _arrived(self, st, frame, row=0):
        lane = st["lane"][:, row:row + 1]
        s, _ = net.frame_at(frame, lane, torch.full_like(lane, row))
        return self._arrival[lane[:, 0].long()] & (s[:, 0] >= 25.0)

    def _reward(self, st, frame):
        speed_r = torch.clamp(lmap(st["speed"][:, 0], 7.0, 9.0, 0.0, 1.0), 0.0, 1.0)
        base = (-5.0 * _f(st["crashed"][:, 0]) + speed_r) * _f(self._on_road(st, frame))
        return torch.where(self._arrived(st, frame), 1.0, base)

    def _terminated(self, st, frame):
        return st["crashed"][:, 0] | self._arrived(st, frame)


class IntersectionEnv(_IntersectionBase):
    """Intersection-v0: longitudinal-only discrete control."""

    ACTION_MODE = "discrete3"

    def state_spec(self):
        return _kin_spec(15, 7)

    def _obs(self, st, frame):
        obs = self._kinematics(st, frame, 15,
                               ["presence", "x", "y", "vx", "vy", "cos_h", "sin_h"],
                               absolute=True, include_obstacles=False, x_rng=(-100.0, 100.0),
                               y_rng=(-100.0, 100.0), v_rng=(-20.0, 20.0))
        return {"obs": obs, **self._common_info(st)}


class IntersectionContinuousEnv(_IntersectionBase):
    """Intersection-v1 (the autopilot quirk of ``net_scenarios``)."""

    ACTION_MODE = "continuous2"

    def state_spec(self):
        return _kin_spec(5, 8)

    def _obs(self, st, frame):
        obs = self._kinematics(st, frame, 5, ["presence", "x", "y", "vx", "vy", "long_off",
                                              "lat_off", "ang_off"])
        return {"obs": obs, **self._common_info(st)}


class IntersectionMultiAgentEnv(_IntersectionBase):
    """IntersectionMultiAgent-v0/v1: two MDP egos with per-player
    longitudinal actions, obs and rewards (native_task_env.h:446-466,
    929-956)."""

    SCENARIO = "intersection_multi"
    ACTION_MODE = "multi3"
    EGO_ROWS = (0, 1)
    _KIN = ["presence", "x", "y", "vx", "vy"]

    def state_spec(self):
        return {
            "obs:players.obs": ArraySpec(np.float32, (-1, 5, 5), -_INF, _INF),
            "info:players.speed": ArraySpec(np.float32, (-1,)),
            "info:players.crashed": ArraySpec(np.bool_, (-1,)),
        }

    def _obs(self, st, frame):
        obs_p = torch.stack([self._kinematics(st, frame, 5, self._KIN, observer=i)
                             for i in range(2)], 1)
        return {
            "obs:players.obs": obs_p,
            "info:players.speed": st["speed"][:, :2],
            "info:players.crashed": st["crashed"][:, :2],
        }

    def _reward(self, st, frame):
        rewards = []
        for p in range(2):
            speed_r = torch.clamp(lmap(st["speed"][:, p], 7.0, 9.0, 0.0, 1.0), 0.0, 1.0)
            base = (-5.0 * _f(st["crashed"][:, p]) + speed_r) * _f(self._on_road(st, frame, p))
            rewards.append(torch.where(self._arrived(st, frame, p), 1.0, base))
        return torch.stack(rewards, 1)

    def _terminated(self, st, frame):
        any_crashed = st["crashed"][:, 0] | st["crashed"][:, 1]
        return any_crashed | (self._arrived(st, frame, 0) & self._arrived(st, frame, 1))


class RacetrackEnv(NetworkScenarioEnv):
    """Racetrack-v0: continuous steering, occupancy-grid observation."""

    SCENARIO = "racetrack"
    ACTION_MODE = "steer"
    DEFAULT_CONFIG = dict(NetworkScenarioEnv.DEFAULT_CONFIG,
                          duration=300, policy_frequency=5)

    def state_spec(self):
        return {
            "obs": ArraySpec(np.float32, (2, 12, 12), -_INF, _INF),
            "info:speed": ArraySpec(np.float32, ()),
            "info:crashed": ArraySpec(np.bool_, ()),
        }

    def _obs(self, st, frame):
        return {"obs": self._occupancy(st, frame), **self._common_info(st)}

    def _reward(self, st, frame):
        lane = st["lane"][:, :1]
        _, lat = net.frame_at(frame, lane, torch.zeros_like(lane))
        lat = lat[:, 0]
        centering = 1.0 / (1.0 + 4.0 * lat * lat)
        weighted = centering - 0.3 * st["last_steer"] - _f(st["crashed"][:, 0])
        return lmap(weighted, -1.0, 1.0, 0.0, 1.0) * _f(self._on_road(st, frame))

    def _terminated(self, st, frame):
        return st["crashed"][:, 0] | ~self._on_road(st, frame)


class RacetrackLargeEnv(RacetrackEnv):
    SCENARIO = "racetrack_large"


class RacetrackOvalEnv(RacetrackEnv):
    SCENARIO = "racetrack_oval"
