"""Parking (goal-conditioned) and LaneKeeping, batched in PyTorch.

Counterpart of ``envpool_tpu/envs/highway/scenarios.py`` (reference:
``envpool/highway/official_task.cc``, ``MakeParkingRoad`` and
``MakeLaneKeepingRoad``).  Both drive one kinematic bicycle per env
(``official_vehicle.cc``: beta = atan(tan(delta) / 2), x' = v cos(psi + beta),
y' = v sin(psi + beta), psi' = v sin(beta) / (L / 2), v' = a).

Parking's reward is -sum_i w_i |a_i - d_i|^p over the scaled goal
features [x/100, y/100, vx/5, vy/5, cos psi, sin psi] with weights
[1, 0.3, 0, 0, 0.02, 0.02] and p = 0.5, success when it exceeds -0.12;
the lot's walls (and the parked cars, where there are any) crash the car
for -5 and end the episode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core.env import EnvOut, TorchEnv
from ...core.rng import Draws
from ...core.specs import ArraySpec
from .network import atan, cos, f32, sin, tan

_LENGTH = 5.0   # vehicle length [m]
_SPOTS = 14
_SPOT_W = 4.0
_Y_OFF = 10.0
_SPOT_LEN = 8.0
_WEIGHTS = (1.0, 0.3, 0.0, 0.0, 0.02, 0.02)
_SCALES = (100.0, 100.0, 5.0, 5.0, 1.0, 1.0)
_SUCCESS = -0.12


def _spot_centers():
    """(x, y, heading) of all 2 x 14 parking-spot centers."""
    xs = (np.arange(1, _SPOTS + 1) - _SPOTS / 2.0) * _SPOT_W - _SPOT_W / 2.0
    top = np.stack([xs, np.full(_SPOTS, _Y_OFF + _SPOT_LEN / 2), np.full(_SPOTS, np.pi / 2)], 1)
    bot = np.stack([xs, np.full(_SPOTS, -_Y_OFF - _SPOT_LEN / 2),
                    np.full(_SPOTS, -np.pi / 2)], 1)
    return np.concatenate([top, bot], 0)  # [28, 3]


def _bicycle(x, y, v, h, steer, acc, dt, n_sub, v_max=None):
    """``n_sub`` kinematic bicycle substeps."""
    beta = atan(0.5 * tan(steer))
    for _ in range(n_sub):
        x = x + v * cos(h + beta) * dt
        y = y + v * sin(h + beta) * dt
        h = h + v * sin(beta) * f32(1.0 / (_LENGTH / 2)) * dt
        if acc is not None:
            v = torch.clamp(v + acc * dt, -v_max, v_max)
    return x, y, v, h


class ParkingEnv(TorchEnv):
    """Parking / ParkingActionRepeat / ParkingParked."""

    DEFAULT_CONFIG = {
        "duration": 100,
        "policy_frequency": 5,
        "simulation_frequency": 15,
        "add_parked_vehicles": False,
        "reward_threshold": 0.0,
    }

    def __init__(self, config):
        super().__init__(config)
        self._spots = torch.as_tensor(_spot_centers().astype(np.float32), device=self.device)
        # (x, y) of the spots' centers, as JAX's float32 spots
        self._weights = torch.as_tensor(np.asarray(_WEIGHTS, np.float32), device=self.device)

    def state_spec(self):
        inf = float("inf")
        return {
            "obs:observation": ArraySpec(np.float32, (6,), -inf, inf),
            "obs:achieved_goal": ArraySpec(np.float32, (6,), -inf, inf),
            "obs:desired_goal": ArraySpec(np.float32, (6,), -inf, inf),
            "info:is_success": ArraySpec(np.bool_, ()),
            "info:crashed": ArraySpec(np.bool_, ()),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (2,), -1.0, 1.0)}

    def _features(self, st):
        x, y, v, h = st["x"], st["y"], st["v"], st["h"]
        c, s = cos(h), sin(h)
        return torch.stack([x * f32(1 / _SCALES[0]), y * f32(1 / _SCALES[1]),
                            v * c * f32(1 / _SCALES[2]), v * s * f32(1 / _SCALES[3]), c, s], -1)

    def _goal_features(self, st):
        g = st["goal"]
        zero = torch.zeros_like(g[:, 0])
        return torch.stack([g[:, 0] * f32(1 / _SCALES[0]), g[:, 1] * f32(1 / _SCALES[1]), zero,
                            zero, cos(g[:, 2]), sin(g[:, 2])], -1)

    def _goal_reward(self, achieved, desired):
        return -(self._weights * torch.sqrt((achieved - desired).abs())).sum(-1)

    def _obs(self, st, crashed, success):
        feats = self._features(st)
        return {
            "obs:observation": feats,
            "obs:achieved_goal": feats,
            "obs:desired_goal": self._goal_features(st),
            "info:is_success": success,
            "info:crashed": crashed,
        }

    def plan_reset(self, d):
        """The reset's draws, in the JAX env's order (``reset_env``)."""
        d.randint("spot", 0, 2 * _SPOTS)
        d.uniform("x", (), -20.0, 20.0)
        d.uniform("h", (), 0.0, 2 * math.pi)

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    def reset_env(self, draws):
        x = draws["x"]
        zeros = torch.zeros_like(x)
        st = {"x": x, "y": zeros, "v": zeros, "h": draws["h"],
              "goal": self._spots[draws["spot"].long()]}
        false = torch.zeros_like(x, dtype=torch.bool)
        return st, self._obs(st, false, false)

    def _parked_mask(self, goal):
        """Spot centers occupied by parked vehicles (first 10 non-goal)."""
        d = self._spots[None, :, :2] - goal[:, None, :2]
        not_goal = torch.sqrt((d * d).sum(-1)) > f32(0.1)
        order = torch.cumsum(not_goal.to(torch.int32), 1)
        return not_goal & (order <= 10)

    def step_env(self, state, action, draws):
        del draws
        a = torch.clamp(action.reshape(-1, 2), -1.0, 1.0)
        acc = a[:, 0] * 5.0
        steer = a[:, 1] * f32(math.pi / 4)
        cfg = self.config
        n_sub = max(1, round(int(cfg["simulation_frequency"]) / int(cfg["policy_frequency"])))
        dt = f32(1.0 / float(cfg["simulation_frequency"]))
        x, y, v, h = _bicycle(state["x"], state["y"], state["v"], state["h"], steer, acc, dt,
                              n_sub, 10.0)
        st = {"x": x, "y": y, "v": v, "h": h, "goal": state["goal"]}
        # Collisions: lot walls and (optionally) parked vehicles.
        crashed = (x.abs() > (_SPOTS / 2 + 1) * _SPOT_W) | (y.abs() > _Y_OFF + _SPOT_LEN + 2)
        if bool(cfg["add_parked_vehicles"]):
            mask = self._parked_mask(state["goal"])
            dx = self._spots[None, :, 0] - x[:, None]
            dy = self._spots[None, :, 1] - y[:, None]
            crashed = crashed | (mask & (torch.sqrt(dx * dx + dy * dy) < 2.0)).any(1)
        reward = self._goal_reward(self._features(st), self._goal_features(st))
        success = reward > f32(_SUCCESS)
        reward = torch.where(crashed, -5.0, reward)
        return EnvOut(state=st, obs=self._obs(st, crashed, success), reward=reward,
                      terminated=crashed | success)


class LaneKeepingEnv(TorchEnv):
    """LaneKeeping-v0: steering-only control on a sinusoidal lane (the
    centerline y = A sin(w x)); constant speed, reward 1 - (lateral error /
    2)^2, off the road ends the episode."""

    DEFAULT_CONFIG = {
        "duration": 20,
        "simulation_frequency": 10,
        "policy_frequency": 10,
        "amplitude": 4.0,
        "pulsation": 2 * np.pi / 100.0,
        "speed": 8.0,
        "reward_threshold": 0.0,
    }

    def state_spec(self):
        return {"obs": ArraySpec(np.float32, (5,), -float("inf"), float("inf"))}

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (1,), -1.0, 1.0)}

    def _lane_y(self, x):
        A = f32(self.config["amplitude"])
        w = f32(self.config["pulsation"])
        return A * sin(w * x), f32(float(self.config["amplitude"])
                                         * float(self.config["pulsation"])) * cos(w * x)

    def _obs_vec(self, st):
        cy, slope = self._lane_y(st["x"])
        herr = st["h"] - atan(slope)
        s = sin(herr)
        return torch.stack([st["y"] - cy, st["v"] * s, cos(herr), s, st["v"]], -1)

    def plan_reset(self, d):
        """The reset's draws, in the JAX env's order (``reset_env``)."""
        d.uniform("y", (), -1.0, 1.0)
        d.uniform("h", (), -0.2, 0.2)

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    def reset_env(self, draws):
        y = draws["y"]
        st = {"x": torch.zeros_like(y), "y": y,
              "v": torch.full_like(y, f32(self.config["speed"])), "h": draws["h"]}
        return st, {"obs": self._obs_vec(st)}

    def step_env(self, state, action, draws):
        del draws
        steer = torch.clamp(action.reshape(-1, 1)[:, 0], -1.0, 1.0) * f32(math.pi / 3)
        dt = f32(1.0 / float(self.config["simulation_frequency"]))
        x, y, v, h = _bicycle(state["x"], state["y"], state["v"], state["h"], steer, None, dt, 1)
        st = {"x": x, "y": y, "v": v, "h": h}
        cy, _ = self._lane_y(x)
        lat = y - cy
        off = lat.abs() > 2 * float(self.config["amplitude"])
        q = lat * 0.5
        reward = torch.clamp_min(1.0 - q * q, 0.0)
        return EnvOut(state=st, obs={"obs": self._obs_vec(st)}, reward=reward, terminated=off)
