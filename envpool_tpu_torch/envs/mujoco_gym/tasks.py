"""Gym-MuJoCo locomotion and manipulation tasks (v4 semantics), batched.

Counterpart of ``envpool_tpu/envs/mujoco_gym/tasks.py`` (reference: the
per-task headers under ``envpool/mujoco/gym/``, which mirror Gymnasium v4):
HalfCheetah, Hopper, Walker2d, Ant, Swimmer, Reacher, InvertedPendulum,
InvertedDoublePendulum and Pusher.  Every function takes and returns
``[N, ...]`` tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import rng
from ...core.specs import ArraySpec
from ...physics.dynamics import body_positions, site_positions
from .base import MujocoGymEnv


def _ctrl_cost(weight, action):
    return float(weight) * torch.sum(action * action, 1)


def _never(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x, dtype=torch.bool)


class _ForwardRewardEnv(MujocoGymEnv):
    """Tasks paid for moving along x: the forward reward and control cost
    with their info fields, and the healthy bonus and termination of the
    tasks that have them."""

    def _forward_terms(self, xv, action, x_position):
        """``(run, ctrl_cost, info)`` of a step with x velocity ``xv``."""
        ctrl_cost = _ctrl_cost(self.config["ctrl_cost_weight"], action)
        run = float(self.config["forward_reward_weight"]) * xv
        info = {
            "reward_run": run,
            "reward_ctrl": -ctrl_cost,
            "x_position": x_position,
            "x_velocity": xv,
        }
        return run, ctrl_cost, info

    def _healthy_terms(self, healthy):
        """``(healthy_reward, terminated)``: v4 pays the bonus every step,
        v5 (``legacy_healthy_reward=False``) only while healthy."""
        bonus = float(self.config["healthy_reward"])
        if bool(self.config["legacy_healthy_reward"]):
            bonus = torch.full_like(healthy, bonus, dtype=torch.float32)
        else:
            bonus = bonus * healthy.to(torch.float32)
        if bool(self.config["terminate_when_unhealthy"]):
            return bonus, ~healthy
        return bonus, _never(healthy)

    def _x_velocity(self, before, after):
        return (after["qpos"][:, 0] - before["qpos"][:, 0]) / self.dt


class HalfCheetahEnv(_ForwardRewardEnv):
    XML = "half_cheetah.xml"
    FRAME_SKIP = 5
    DEFAULT_CONFIG = {
        "reward_threshold": 4800.0,
        "ctrl_cost_weight": 0.1,
        "forward_reward_weight": 1.0,
        "reset_noise_scale": 0.1,
    }

    def observe(self, qpos, qvel):
        if self.config["exclude_current_positions_from_observation"]:
            qpos = qpos[:, 1:]
        return torch.cat([qpos, qvel], 1)

    def reward_done(self, before, after, action):
        xv = self._x_velocity(before, after)
        run, ctrl_cost, info = self._forward_terms(xv, action, after["qpos"][:, 0])
        return run - ctrl_cost, _never(xv), info


class _HealthyLocomotionEnv(_ForwardRewardEnv):
    """Shared Hopper/Walker2d logic: healthy reward and termination."""

    UNIFORM_QVEL_NOISE = True
    HEALTHY_Z = (0.7, float("inf"))
    HEALTHY_ANGLE = (-0.2, 0.2)
    HEALTHY_STATE = (-100.0, 100.0)
    DEFAULT_CONFIG = {
        "ctrl_cost_weight": 1e-3,
        "forward_reward_weight": 1.0,
        "reset_noise_scale": 5e-3,
        "healthy_reward": 1.0,
        "terminate_when_unhealthy": True,
        # v4 pays the healthy bonus every step; v5 only while healthy.
        "legacy_healthy_reward": True,
    }

    def observe(self, qpos, qvel):
        if self.config["exclude_current_positions_from_observation"]:
            qpos = qpos[:, 1:]
        return torch.cat([qpos, torch.clamp(qvel, -10.0, 10.0)], 1)

    def _healthy(self, qpos, qvel):
        z, angle = qpos[:, 1], qpos[:, 2]
        state = torch.cat([qpos[:, 2:], qvel], 1)
        lo, hi = self.HEALTHY_STATE
        ok_state = ((state > lo) & (state < hi)).all(1)
        ok_z = (z > self.HEALTHY_Z[0]) & (z < self.HEALTHY_Z[1])
        ok_angle = (angle > self.HEALTHY_ANGLE[0]) & (angle < self.HEALTHY_ANGLE[1])
        return ok_state & ok_z & ok_angle

    def reward_done(self, before, after, action):
        xv = self._x_velocity(before, after)
        run, ctrl_cost, info = self._forward_terms(xv, action, after["qpos"][:, 0])
        bonus, terminated = self._healthy_terms(
            self._healthy(after["qpos"], after["qvel"])
        )
        return run + bonus - ctrl_cost, terminated, info


class HopperEnv(_HealthyLocomotionEnv):
    XML = "hopper.xml"
    FRAME_SKIP = 4
    DEFAULT_CONFIG = dict(_HealthyLocomotionEnv.DEFAULT_CONFIG)


class Walker2dEnv(_HealthyLocomotionEnv):
    XML = "walker2d.xml"
    FRAME_SKIP = 4
    HEALTHY_Z = (0.8, 2.0)
    HEALTHY_ANGLE = (-1.0, 1.0)
    HEALTHY_STATE = (-float("inf"), float("inf"))
    DEFAULT_CONFIG = dict(_HealthyLocomotionEnv.DEFAULT_CONFIG)


class AntEnv(_ForwardRewardEnv):
    XML = "ant.xml"
    FRAME_SKIP = 5
    DEFAULT_CONFIG = {
        "reward_threshold": 6000.0,
        "ctrl_cost_weight": 0.5,
        "forward_reward_weight": 1.0,
        "reset_noise_scale": 0.1,
        "healthy_reward": 1.0,
        "terminate_when_unhealthy": True,
        "legacy_healthy_reward": True,
        "substeps": 1,
        # ant.xml declares RK4; Euler with implicit contact damping at a
        # full model timestep is the JAX package's default (8x fewer
        # dynamics evaluations).  integrator="model" runs RK4.
        "integrator": "euler",
    }

    def observe(self, qpos, qvel):
        if self.config["exclude_current_positions_from_observation"]:
            qpos = qpos[:, 2:]
        return torch.cat([qpos, qvel], 1)

    def reward_done(self, before, after, action):
        xv = self._x_velocity(before, after)
        run, ctrl_cost, info = self._forward_terms(xv, action, after["qpos"][:, 0])
        z = after["qpos"][:, 2]
        bonus, terminated = self._healthy_terms((z > 0.2) & (z < 1.0))
        return run + bonus - ctrl_cost, terminated, info


class SwimmerEnv(_ForwardRewardEnv):
    XML = "swimmer.xml"
    FRAME_SKIP = 4
    UNIFORM_QVEL_NOISE = True
    DEFAULT_CONFIG = {
        "reward_threshold": 360.0,
        "ctrl_cost_weight": 1e-4,
        "forward_reward_weight": 1.0,
        "reset_noise_scale": 0.1,
    }

    def observe(self, qpos, qvel):
        if self.config["exclude_current_positions_from_observation"]:
            qpos = qpos[:, 2:]
        return torch.cat([qpos, qvel], 1)

    def reward_done(self, before, after, action):
        xv = self._x_velocity(before, after)
        run, ctrl_cost, info = self._forward_terms(xv, action, after["qpos"][:, 0])
        return run - ctrl_cost, _never(xv), info


class ReacherEnv(MujocoGymEnv):
    XML = "reacher.xml"
    FRAME_SKIP = 2
    DEFAULT_CONFIG = {
        "reward_threshold": -3.75,
        "reset_noise_scale": 0.1,
        # v5: distance measured after the step and the constant z of the
        # fingertip-target vector dropped (10-dim obs).
        "reward_after_step": False,
        "v5_obs": False,
    }

    def __init__(self, config):
        super().__init__(config)
        self._fingertip = self.model.body_names.index("fingertip")
        self._target = self.model.body_names.index("target")

    def reset_draws(self, sub):
        """The arm's angles, the goal on the radius-0.2 disk as a uniform
        ``goal_u`` (radius ``0.2·√u``) and an angle, and the arm's speeds."""
        return {
            "arm": rng.uniform_range(sub, -0.1, 0.1, 2),
            "goal_u": rng.uniform(sub, 2),
            "goal_angle": rng.uniform_range(sub, 0.0, 2.0 * math.pi, 1, slot=3)[:, 0],
            "arm_vel": rng.uniform_range(sub, -0.005, 0.005, 2, slot=4),
        }

    def reset_qpos_qvel(self, draws):
        # Gym rejection-samples the goal in a square and keeps it in the
        # disk; uniform on the disk is the same law.
        r = 0.2 * torch.sqrt(draws["goal_u"])
        theta = draws["goal_angle"]
        goal = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], 1)
        qpos = torch.cat([self._qpos0[:2] + draws["arm"], goal], 1)
        qvel = torch.cat([draws["arm_vel"], torch.zeros_like(goal)], 1)
        return qpos, qvel

    def _vec(self, qpos):
        # gym's get_body_com is data.body(name).xpos: the body frame origin.
        ps = body_positions(self.model, qpos)
        return ps[:, self._fingertip] - ps[:, self._target]

    def observe(self, qpos, qvel):
        vec = self._vec(qpos)
        if bool(self.config["v5_obs"]):
            vec = vec[:, :2]
        return torch.cat(
            [torch.cos(qpos[:, :2]), torch.sin(qpos[:, :2]), qpos[:, 2:4],
             qvel[:, :2], vec],
            1,
        )

    def extra_info_spec(self):
        return {
            "info:reward_dist": ArraySpec(np.float32, ()),
            "info:reward_ctrl": ArraySpec(np.float32, ()),
        }

    def reward_done(self, before, after, action):
        which = after if bool(self.config["reward_after_step"]) else before
        reward_dist = -torch.linalg.vector_norm(self._vec(which["qpos"]), dim=1)
        reward_ctrl = -torch.sum(action * action, 1)
        return (
            reward_dist + reward_ctrl,
            _never(reward_dist),
            {"reward_dist": reward_dist, "reward_ctrl": reward_ctrl},
        )


class InvertedPendulumEnv(MujocoGymEnv):
    XML = "inverted_pendulum.xml"
    FRAME_SKIP = 2
    UNIFORM_QVEL_NOISE = True
    DEFAULT_CONFIG = {
        "reward_threshold": 950.0,
        "reset_noise_scale": 0.01,
        # v5: no reward on the terminating step.
        "reward_if_not_terminated": False,
    }

    def observe(self, qpos, qvel):
        return torch.cat([qpos, qvel], 1)

    def extra_info_spec(self):
        return {}

    def reward_done(self, before, after, action):
        terminated = after["qpos"][:, 1].abs() > 0.2
        reward = torch.ones_like(after["qpos"][:, 1])
        if bool(self.config["reward_if_not_terminated"]):
            reward = torch.where(terminated, 0.0, reward)
        return reward, terminated, {}


class InvertedDoublePendulumEnv(MujocoGymEnv):
    XML = "inverted_double_pendulum.xml"
    FRAME_SKIP = 5
    TIP_FLOOR = 1.0  # terminated once the tip's height is at most this
    DEFAULT_CONFIG = {
        "reward_threshold": 9100.0,
        "reset_noise_scale": 0.1,
        "reward_if_not_terminated": False,
    }

    def __init__(self, config):
        super().__init__(config)
        self._tip_site = self.model.site_names.index("tip")

    def observe(self, qpos, qvel):
        # qfrc_constraint is zero in the penalty engine; its 3 slots stay
        # for the reference's 11-dim layout.
        return torch.cat(
            [qpos[:, :1], torch.sin(qpos[:, 1:]), torch.cos(qpos[:, 1:]),
             torch.clamp(qvel, -10.0, 10.0), qvel.new_zeros(qvel.shape[0], 3)],
            1,
        )

    def extra_info_spec(self):
        return {}

    def _tip(self, qpos):
        return site_positions(self.model, qpos)[:, self._tip_site]

    def reward_done(self, before, after, action):
        tip = self._tip(after["qpos"])
        x, y = tip[:, 0], tip[:, 2]
        dist_penalty = 0.01 * x * x + (y - 2.0) ** 2
        v1, v2 = after["qvel"][:, 1], after["qvel"][:, 2]
        vel_penalty = 1e-3 * v1 * v1 + 5e-3 * v2 * v2
        reward = 10.0 - dist_penalty - vel_penalty
        terminated = y <= self.TIP_FLOOR
        if bool(self.config["reward_if_not_terminated"]):
            reward = torch.where(terminated, 0.0, reward)
        return reward, terminated, {}

    def termination_margin(self, state):
        return (self._tip(state["qpos"])[:, 2] - self.TIP_FLOOR).abs()


class PusherEnv(MujocoGymEnv):
    """Pusher (a 7-dof arm pushes a cylinder to a goal).

    obs = [qpos[:7], qvel[:7], tips_arm, object, goal positions] (23);
    reward = −|object − goal| − 0.1·|a|² − 0.5·|object − tips_arm|, measured
    before the step in v4 and after it in v5 (``reward_after_step``).

    The reset draws the cylinder uniformly in x ∈ [−0.3, 0), y ∈ [−0.2, 0.2)
    until it lies more than 0.17 from the goal at the origin (JAX's
    ``lax.while_loop``).  Batched, each env draws ``CANDIDATES`` positions
    at once and takes the first accepted one.  One is rejected with
    probability (π·0.17²/2)/(0.3·0.4) ≈ 0.378, so all 32 are with
    probability ≈ 3e-14 per reset; the env then takes the last candidate,
    which lies within 0.17 of the goal.
    """

    XML = "pusher.xml"
    FRAME_SKIP = 5
    CANDIDATES = 32
    DEFAULT_CONFIG = {
        "reward_threshold": 0.0,
        # v5 measures distances after stepping and uses pusher_v5.xml.
        "reward_after_step": False,
        "reward_near_weight": 0.5,
        "reward_dist_weight": 1.0,
        "reward_control_weight": 0.1,
    }

    def __init__(self, config):
        super().__init__(config)
        names = self.model.body_names
        self._tips = names.index("tips_arm")
        self._object = names.index("object")
        self._goal = names.index("goal")

    def reset_draws(self, sub):
        """``cylinder`` ``[N, CANDIDATES, 2]`` candidate positions and
        ``qvel_noise`` ``[N, nv]`` uniform in ``[-0.005, 0.005)``."""
        k = self.CANDIDATES
        x = rng.uniform_range(sub, -0.3, 0.0, k)
        y = rng.uniform_range(sub, -0.2, 0.2, k, slot=k)
        return {
            "cylinder": torch.stack([x, y], 2),
            "qvel_noise": rng.uniform_range(
                sub, -0.005, 0.005, self.model.nv, slot=2 * k
            ),
        }

    def reset_qpos_qvel(self, draws):
        cands = draws["cylinder"]
        accepted = torch.linalg.vector_norm(cands, dim=2) > 0.17
        last = cands.shape[1] - 1
        first = torch.where(
            accepted.any(1), accepted.to(torch.int32).argmax(1), last
        )
        cyl = cands[torch.arange(cands.shape[0], device=cands.device), first]
        n = cyl.shape[0]
        qpos = torch.cat(
            [self._qpos0[:-4].expand(n, -1), cyl, cyl.new_zeros(n, 2)], 1
        )
        qvel = draws["qvel_noise"].clone()
        qvel[:, -4:] = 0.0
        return qpos, qvel

    def _coms(self, qpos):
        # gym's get_body_com is data.body(name).xpos (the frame origin).
        ps = body_positions(self.model, qpos)
        return ps[:, self._tips], ps[:, self._object], ps[:, self._goal]

    def observe(self, qpos, qvel):
        tips, obj, goal = self._coms(qpos)
        return torch.cat([qpos[:, :7], qvel[:, :7], tips, obj, goal], 1)

    def extra_info_spec(self):
        return {
            "info:reward_dist": ArraySpec(np.float32, ()),
            "info:reward_ctrl": ArraySpec(np.float32, ()),
            "info:reward_near": ArraySpec(np.float32, ()),
        }

    def reward_done(self, before, after, action):
        which = after if bool(self.config["reward_after_step"]) else before
        tips, obj, goal = self._coms(which["qpos"])
        cfg = self.config
        near = -torch.linalg.vector_norm(obj - tips, dim=1) * float(
            cfg["reward_near_weight"]
        )
        dist = -torch.linalg.vector_norm(obj - goal, dim=1) * float(
            cfg["reward_dist_weight"]
        )
        ctrl = -_ctrl_cost(cfg["reward_control_weight"], action)
        return (
            dist + ctrl + near,
            _never(dist),
            {"reward_dist": dist, "reward_ctrl": ctrl, "reward_near": near},
        )
