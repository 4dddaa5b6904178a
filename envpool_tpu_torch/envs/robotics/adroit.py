"""AdroitHand family: Door, Hammer, Pen and Relocate (dense and sparse),
batched in PyTorch.

Counterpart of ``envpool_tpu/envs/robotics/adroit.py`` (reference:
``envpool/mujoco/robotics/adroit.h``, gymnasium_robotics
``envs/adroit_hand/adroit_{door,hammer,pen,relocate}.py``, pip 1.4.1
semantics, its dense-reward quirks included): the hand and arm are a
rate-limited servo bank, the palm a fixed linear map of the hand's qpos
(built from ``default_rng(7)`` as the JAX env builds it), and the task
objects follow the JAX env's interaction rules.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut, TorchEnv
from ...core.rng import Draws
from ...core.specs import ArraySpec
from ...ops.batched import const, cos, inv, norm, sin
from .hand import quat2euler

__all__ = ["AdroitEnv"]

_DT = 0.04
_SERVO_GAIN = 0.3
_SERVO_CAP = 0.4


class AdroitEnv(TorchEnv):
    """All 4 Adroit tasks by the ``adroit_task`` config key."""

    DEFAULT_CONFIG = {
        "reward_threshold": 0.0,
        "xml_file": "adroit_hand/adroit_door.xml",
        "adroit_task": "door",
        "reward_type": "dense",
        "obs_dim": 39,
        "action_dim": 28,
        "qpos_dim": 30,
        "qvel_dim": 30,
        "reset_dim": 3,
    }

    def __init__(self, config):
        super().__init__(config)
        self.task = str(config["adroit_task"])
        self.sparse = str(config["reward_type"]) == "sparse"
        self.obs_dim = int(config["obs_dim"])
        self.na = int(config["action_dim"])
        self.nq = int(config["qpos_dim"])
        # The arm's translation joints move the palm: a fixed linear map
        # stands in for the arm's FK.
        rng = np.random.default_rng(7)
        J = np.zeros((3, self.na), np.float32)
        J[0, 0] = 0.25
        J[1, 1] = 0.25
        J[2, 2 % self.na] = 0.2
        J += 0.01 * rng.standard_normal(J.shape).astype(np.float32)
        self._palm_jac = J
        self._palm0 = np.asarray([0.0, 0.0, 0.2], np.float32)
        dev = self.device
        self._J = torch.as_tensor(J, device=dev)
        self._p0 = torch.as_tensor(self._palm0, device=dev)
        # The hammer's obs holds the Euler angles of the identity.
        self._euler0 = quat2euler(torch.tensor([[1.0, 0.0, 0.0, 0.0]]))[0].to(dev)

    # -- specs ------------------------------------------------------------------

    def state_spec(self):
        inf = float("inf")
        return {
            "obs": ArraySpec(np.float32, (self.obs_dim,), -inf, inf),
            "info:success": ArraySpec(np.float32, (), 0.0, 1.0),
            "info:qpos0": ArraySpec(np.float32, (self.nq,)),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (self.na,), -1.0, 1.0)}

    # -- the shared hand servo ----------------------------------------------------

    def _servo(self, qh, action):
        target = torch.clamp(action, -1.0, 1.0) * 1.5
        delta = torch.clamp(_SERVO_GAIN * (target - qh), -_SERVO_CAP, _SERVO_CAP)
        new = torch.clamp(qh + delta, -1.6, 1.6)
        return new, (new - qh) * inv(_DT)

    def _palm(self, qh):
        return self._p0 + qh @ self._J.T

    def _curl(self, qh):
        """Mean finger flexion in [0, 1] (the grasp proxy)."""
        return torch.clamp(qh[:, 6:18].mean(1), 0.0, 1.5) * inv(1.5)

    # -- draws ------------------------------------------------------------------

    def plan_reset(self, d):
        """The reset's draws, in the JAX env's order (one scalar each)."""
        bounds = {
            "door": ((-0.3, -0.2), (0.25, 0.35), (0.252, 0.35)),
            "hammer": ((0.1, 0.25),),
            "pen": ((-1.0, 1.0), (-1.0, 1.0)),
            "relocate": ((-0.15, 0.15), (-0.15, 0.3), (-0.2, 0.2), (-0.2, 0.2), (0.15, 0.35)),
        }[self.task]
        for i, (lo, hi) in enumerate(bounds):
            d.uniform(f"u{i}", (), lo, hi)

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    # -- per-task logic -----------------------------------------------------------

    def reset_env(self, draws):
        n = draws["rows"].shape[0]
        dev = draws["rows"].device
        zeros = torch.zeros(n, self.na, device=dev)
        st = {"qh": zeros, "qvh": zeros.clone()}
        u = [draws.get(f"u{i}") for i in range(5)]
        zero = torch.zeros(n, device=dev)
        if self.task == "door":
            st["door_xyz"] = torch.stack(u[:3], 1)
            st["hinge"] = zero
            st["latch"] = zero.clone()
        elif self.task == "hammer":
            st["board_z"] = u[0]
            st["nail_depth"] = zero
            st["hamm_pos"] = const((0.0, -0.2, 0.035), dev).expand(n, 3).clone()
            st["held"] = torch.zeros(n, dtype=torch.bool, device=dev)
        elif self.task == "pen":
            e0, e1, e2 = u[0], u[1], zero
            tar = torch.stack([cos(e1) * cos(e2), cos(e1) * sin(e2) + sin(e0) * 0.0,
                               -sin(e1)], 1)
            st["tar_orien"] = tar / norm(tar)[:, None]
            st["obj_orien"] = const((1.0, 0.0, 0.0), dev).expand(n, 3).clone()
            st["obj_pos"] = const((0.0, 0.0, 0.15), dev).expand(n, 3).clone()
        elif self.task == "relocate":
            st["obj_pos"] = torch.stack([u[0], u[1], torch.full_like(zero, 0.035)], 1)
            st["target"] = torch.stack(u[2:5], 1)
            st["held"] = torch.zeros(n, dtype=torch.bool, device=dev)
        return st, self._obs(st)

    def _world(self, st):
        palm = self._palm(st["qh"])
        dev = palm.device
        if self.task == "door":
            door = st["door_xyz"] + const((0.1, 0.2, 0.05), dev)
            # The handle swings with the hinge about the door frame.
            h = st["hinge"]
            handle = door + torch.stack([-0.3 * sin(h), -0.3 * (1 - cos(h)),
                                         torch.zeros_like(h)], 1)
            return palm, handle, door
        if self.task == "hammer":
            nail = (const((0.0, 0.18, 0.0), dev)
                    + const((0.0, 0.0, 1.0), dev) * st["board_z"][:, None])
            goal = nail + torch.stack([torch.zeros_like(st["nail_depth"]),
                                       st["nail_depth"] - 0.09,
                                       torch.zeros_like(st["nail_depth"])], 1)
            head = st["hamm_pos"] + const((0.0, 0.08, 0.0), dev)
            return palm, nail, goal, head
        if self.task == "pen":
            return palm, const((0.0, -0.2, 0.25), dev)
        return palm, st["obj_pos"], st["target"]

    def _qmid(self, qh, width):
        """The qpos slice the oracle's obs starts with (``width`` entries)."""
        if self.na >= width:
            return qh[:, self.na - width:]
        return torch.cat([qh, qh.new_zeros(qh.shape[0], width - self.na)], 1)

    def _obs(self, st):
        palm = self._palm(st["qh"])
        qh, qvh = st["qh"], st["qvh"]
        n = qh.shape[0]
        if self.task == "door":
            _, handle, _ = self._world(st)
            # qpos: [unused(1), hand(na), door(1), latch(1)]; the obs drops
            # qpos[0] and the last two, then appends them again.
            door_open = torch.where(st["hinge"] > 1.0, 1.0, -1.0)
            obs = torch.cat([self._qmid(qh, self.nq - 3), st["latch"][:, None],
                             st["hinge"][:, None], palm, handle, palm - handle,
                             door_open[:, None]], 1)
        elif self.task == "hammer":
            _, nail, goal, head = self._world(st)
            qv6 = torch.cat([qvh[:, :2], qvh.new_zeros(n, 4)], 1)
            obs = torch.cat([self._qmid(qh, self.nq - 6), torch.clamp(qv6, -1.0, 1.0), palm,
                             st["hamm_pos"], self._euler0.expand(n, 3), nail,
                             qh.new_zeros(n, 1)], 1)  # the nail's impact sensor
        elif self.task == "pen":
            _, desired_loc = self._world(st)
            obs = torch.cat([self._qmid(qh, self.nq - 6), st["obj_pos"], qh.new_zeros(n, 6),
                             st["obj_orien"], st["tar_orien"], st["obj_pos"] - desired_loc,
                             st["obj_orien"] - st["tar_orien"]], 1)
        else:
            obs = torch.cat([self._qmid(qh, self.nq - 6), palm - st["obj_pos"],
                             palm - st["target"], st["obj_pos"] - st["target"]], 1)
        obs = obs[:, : self.obs_dim]
        pad = self.obs_dim - obs.shape[1]
        if pad > 0:
            obs = torch.cat([obs, obs.new_zeros(n, pad)], 1)
        return {
            "obs": obs,
            "info:success": self._success(st).to(torch.float32),
            "info:qpos0": qh.new_zeros(n, self.nq),
        }

    def _success(self, st):
        if self.task == "door":
            return st["hinge"] >= 1.35
        if self.task == "hammer":
            return torch.abs(0.09 - st["nail_depth"]) < 0.01
        if self.task == "pen":
            _, desired_loc = self._world(st)
            d = norm(st["obj_pos"] - desired_loc)
            sim = (st["obj_orien"] * st["tar_orien"]).sum(1)
            return (d < 0.075) & (sim > 0.95)
        return norm(st["obj_pos"] - st["target"]) < 0.1

    def step_env(self, state, action, draws):
        del draws
        action = action.reshape(-1, self.na).to(torch.float32)
        qh, qvh = self._servo(state["qh"], action)
        st = dict(state, qh=qh, qvh=qvh)
        palm = self._palm(qh)
        curl = self._curl(qh)
        dev = qh.device

        if self.task == "door":
            _, handle, _ = self._world(st)
            near = norm(palm - handle) < 0.12
            # The latch turns while grasped; the hinge follows the palm's pull.
            st["latch"] = torch.clamp(
                st["latch"] + torch.where(near, 1.2 * curl * _DT * 25.0, 0.0), 0.0, 1.8)
            pull = -(qvh @ self._J[0]) * _DT
            unlocked = st["latch"] > 1.0
            st["hinge"] = torch.clamp(
                st["hinge"] + torch.where(near & unlocked, torch.clamp_min(pull, 0.0) * 20.0,
                                          0.0), 0.0, 1.57)
            hinge = st["hinge"]
            dense = (0.1 * norm(palm - handle) - 0.1 * (hinge - 1.57) ** 2
                     - 1e-5 * (qvh ** 2).sum(1)
                     + torch.where(hinge > 0.2, 2.0, 0.0)
                     + torch.where(hinge > 1.0, 8.0, 0.0)
                     + torch.where(hinge > 1.35, 10.0, 0.0))
        elif self.task == "hammer":
            near = norm(palm - state["hamm_pos"]) < 0.1
            grab = near & (curl > 0.3)
            st["held"] = state["held"] | grab
            st["hamm_pos"] = torch.where(st["held"][:, None],
                                         palm + const((0.0, 0.05, -0.02), dev),
                                         state["hamm_pos"])
            _, nail, goal, head = self._world(st)
            strike = (norm(head - nail) < 0.05) & st["held"]
            speed = norm(qvh @ self._J.T)
            st["nail_depth"] = torch.clamp(
                state["nail_depth"] + torch.where(strike, 0.02 * speed, 0.0), 0.0, 0.09)
            gd = torch.abs(0.09 - st["nail_depth"])
            dense = (0.1 * norm(palm - st["hamm_pos"]) - norm(head - nail) - 10.0 * gd
                     - 1e-2 * norm(qvh)
                     + torch.where((st["hamm_pos"][:, 2] > 0.04) & (head[:, 2] > 0.04), 2.0,
                                   0.0)
                     + torch.where(gd < 0.02, 25.0, 0.0)
                     + torch.where(gd < 0.01, 75.0, 0.0))
        elif self.task == "pen":
            # The pen's orientation follows the fingers' twist.
            w = torch.stack([qvh[:, 6:12].mean(1), qvh[:, 12:18].mean(1),
                             qvh[:, 2:6].mean(1)], 1) * 0.3 * _DT
            o = st["obj_orien"] + torch.linalg.cross(w, st["obj_orien"], dim=1)
            st["obj_orien"] = o / (norm(o) + 1e-8)[:, None]
            drop = curl < 0.05
            st["obj_pos"] = torch.where(drop[:, None],
                                        state["obj_pos"] + const((0.0, 0.0, -0.04), dev),
                                        state["obj_pos"])
            _, desired_loc = self._world(st)
            gd = norm(st["obj_pos"] - desired_loc)
            sim = (st["obj_orien"] * st["tar_orien"]).sum(1)
            dense = (-gd + sim
                     + torch.where((gd < 0.075) & (sim > 0.9), 10.0, 0.0)
                     + torch.where((gd < 0.075) & (sim > 0.95), 50.0, 0.0)
                     - torch.where(st["obj_pos"][:, 2] < 0.075, 5.0, 0.0))
        else:
            near = norm(palm - state["obj_pos"]) < 0.08
            grab = near & (curl > 0.3)
            st["held"] = (state["held"] | grab) & (curl > 0.1)
            st["obj_pos"] = torch.where(st["held"][:, None],
                                        palm + const((0.0, 0.0, -0.04), dev),
                                        state["obj_pos"])
            gd = norm(st["obj_pos"] - st["target"])
            lifted = st["obj_pos"][:, 2] > 0.04
            dense = (0.1 * norm(palm - st["obj_pos"])
                     + torch.where(lifted,
                                   1.0 - 0.5 * norm(palm - st["target"]) - 0.5 * gd, 0.0)
                     + torch.where(gd < 0.1, 10.0, 0.0)
                     + torch.where(gd < 0.05, 20.0, 0.0))

        succ = self._success(st)
        reward = torch.where(succ, 10.0, -0.1) if self.sparse else dense
        return EnvOut(state=st, obs=self._obs(st), reward=reward,
                      terminated=torch.zeros_like(succ))
