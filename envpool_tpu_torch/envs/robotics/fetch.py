"""Fetch family (Reach, Push, Slide, PickAndPlace; sparse and dense),
batched in PyTorch.

Counterpart of ``envpool_tpu/envs/robotics/fetch.py`` (reference:
``envpool/mujoco/robotics/fetch.h``, gymnasium_robotics
``envs/fetch/fetch_env.py``): the arm is modelled at the end effector, as
the JAX env does (first-order tracking of the mocap target inside a
workspace box, a rate-limited finger servo, the object pushed, grasped or
sliding with Coulomb decay); goal sampling, the success predicate, the
reward and the observation layout are the oracle's.

The JAX env places the object by a ``lax.while_loop`` over ``fold_in``
keys until its xy lies at least 0.1 from the gripper's; the port draws
``ACCEPT_K`` candidates a row and takes the first that does
(:meth:`envpool_tpu_torch.core.rng.Draws.accept`), so a reset is one
program for nearly every batch.  A test hands in the value JAX's loop
accepted under the same name, ``object_xy``.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut, TorchEnv
from ...core.rng import Draws
from ...core.specs import ArraySpec
from ...ops.batched import f32, inv, norm

__all__ = ["FetchEnv"]

_DT = 0.04            # n_substeps(20) * timestep(0.002)
_TRACK_GAIN = 0.63    # fraction of the 0.05 m command realised per step
_VELP_SCALE = 0.7     # end-of-step site velocity vs mean displacement
_FINGER_MAX = 0.05
_FINGER_GAIN = 0.7
_GRASP_DIST = 0.05    # ee-object distance that allows a grasp
_PUSH_RADIUS = 0.048  # gripper/object contact distance (block half 0.025)

# Per-xml constants measured from the oracle at reset.
_INIT = {
    "fetch/reach.xml": ((1.34183, 0.7491, 0.53473), 0.0),
    "fetch/push.xml": ((1.36313, 0.7491, 0.41601), 0.42489),
    "fetch/slide.xml": ((1.01327, 0.74915, 0.4155), 0.42),
    "fetch/pick_and_place.xml": ((1.34193, 0.7491, 0.53473), 0.42489),
}
_WORKSPACE_LO = (0.63, -0.31)
_WORKSPACE_HI = (1.80, 1.01)
_Z_CEIL = 1.34


class FetchEnv(TorchEnv):
    """FetchReach/Push/Slide/PickAndPlace (+Dense, v1/v4) by config."""

    DEFAULT_CONFIG = {
        "reward_threshold": 0.0,
        "xml_file": "fetch/reach.xml",
        "reward_type": "sparse",
        "has_object": False,
        "block_gripper": True,
        "target_in_the_air": True,
        "gripper_extra_height": 0.2,
        "target_offset_x": 0.0,
        "target_offset_y": 0.0,
        "target_offset_z": 0.0,
        "obj_range": 0.15,
        "target_range": 0.15,
        "distance_threshold": 0.05,
        "initial_slide0": 0.4049,
        "initial_slide1": 0.48,
        "initial_slide2": 0.0,
        "initial_object_x": 1.25,
        "initial_object_y": 0.53,
        "initial_object_z": 0.4,
        # Slide pucks keep momentum; everything else is quasi-static.
        "object_friction_decel": 1.0,
    }

    def __init__(self, config):
        super().__init__(config)
        self.has_object = bool(config["has_object"])
        self.block_gripper = bool(config["block_gripper"])
        self.sparse = str(config["reward_type"]) == "sparse"
        self.thr = float(config["distance_threshold"])
        init_grip, height = _INIT[str(config["xml_file"])]
        self.init_grip = np.asarray(init_grip, np.float32)
        self.height_offset = float(height)
        self.target_offset = np.asarray(
            [float(config["target_offset_x"]), float(config["target_offset_y"]),
             float(config["target_offset_z"])], np.float32)
        self.obj_range = float(config["obj_range"])
        self.target_range = float(config["target_range"])
        self.in_air = bool(config["target_in_the_air"])
        self.obs_dim = 25 if self.has_object else 10
        # ee z floor: touching the table (object tasks) or free (reach).
        self.z_floor = 0.41 if self.height_offset else 0.417
        dev = self.device
        self._grip0 = torch.as_tensor(self.init_grip, device=dev)
        self._offset = torch.as_tensor(self.target_offset, device=dev)
        self._ws_lo = torch.as_tensor(
            np.asarray([*_WORKSPACE_LO, self.z_floor], np.float32), device=dev)
        self._ws_hi = torch.as_tensor(np.asarray([*_WORKSPACE_HI, _Z_CEIL], np.float32),
                                      device=dev)

    # -- specs ------------------------------------------------------------------

    def state_spec(self):
        inf = float("inf")
        return {
            "obs:observation": ArraySpec(np.float32, (self.obs_dim,), -inf, inf),
            "obs:achieved_goal": ArraySpec(np.float32, (3,), -inf, inf),
            "obs:desired_goal": ArraySpec(np.float32, (3,), -inf, inf),
            "info:is_success": ArraySpec(np.float32, (), 0.0, 1.0),
            "info:distance": ArraySpec(np.float32, (), 0.0, inf),
            "info:goal0": ArraySpec(np.float32, (3,)),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (4,), -1.0, 1.0)}

    # -- the oracle's pure functions ------------------------------------------

    def compute_reward(self, achieved, desired):
        """fetch_env.py BaseFetchEnv.compute_reward."""
        d = norm(achieved - desired)
        if self.sparse:
            return -(d > self.thr).to(torch.float32)
        return -d

    def _object_ok(self, xy: torch.Tensor) -> torch.Tensor:
        """The placement predicate: at least 0.1 from the gripper's xy."""
        return norm(xy - self._grip0[:2]) >= 0.1

    def plan_reset(self, d):
        """The reset's draws, in the JAX env's order: the goal's noise, its
        lift and the lift's coin (``sample_goal``), then the object's xy."""
        r = self.target_range
        d.uniform("goal_noise", (3,), -r, r)
        if self.has_object and self.in_air:
            d.uniform("lift", (), 0.0, 0.45)
            d.uniform("lift_coin")
        if self.has_object:
            o = self.obj_range
            d.accept("object_xy",
                     lambda s, k: self._grip0[:2] + s.uniform("xy", (k, 2), -o, o),
                     self._object_ok)

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    def sample_goal(self, draws):
        """fetch_env.py _sample_goal: ``[N, 3]``."""
        goal = self._grip0 + draws["goal_noise"]
        if not self.has_object:
            return goal
        goal = goal + self._offset
        z = torch.full_like(goal[:, 2], f32(self.height_offset))
        if self.in_air:
            z = z + torch.where(draws["lift_coin"] < 0.5, draws["lift"], 0.0)
        return torch.cat([goal[:, :2], z[:, None]], 1)

    # -- dynamics ---------------------------------------------------------------

    def _obs(self, st):
        grip_pos, grip_velp = st["grip_pos"], st["grip_velp"]
        if self.has_object:
            # Oracle: the object site's velocity * dt, minus grip_velp.
            obj_velp = st["obj_velp"] * _DT - grip_velp
            obj_pos = st["obj_pos"]
            obs = torch.cat([grip_pos, obj_pos, obj_pos - grip_pos, st["fingers"],
                             st["obj_rot"], obj_velp, torch.zeros_like(obj_velp), grip_velp,
                             st["finger_vel"]], 1)
            achieved = obj_pos
        else:
            obs = torch.cat([grip_pos, st["fingers"], grip_velp, st["finger_vel"]], 1)
            achieved = grip_pos
        d = norm(achieved - st["goal"])
        return {
            "obs:observation": obs,
            "obs:achieved_goal": achieved,
            "obs:desired_goal": st["goal"],
            "info:is_success": (d < self.thr).to(torch.float32),
            "info:distance": d,
            "info:goal0": st["goal"],
        }

    def reset_env(self, draws):
        goal = self.sample_goal(draws)
        n = goal.shape[0]
        zeros3 = goal.new_zeros(n, 3)
        if self.has_object:
            xy = draws["object_xy"]
            obj_pos = torch.cat([xy, torch.full_like(xy[:, :1], f32(self.height_offset))], 1)
        else:
            obj_pos = zeros3
        st = {
            "grip_pos": self._grip0.expand(n, 3).clone(),
            "grip_velp": zeros3,
            "fingers": goal.new_zeros(n, 2),
            "finger_vel": goal.new_zeros(n, 2),
            "obj_pos": obj_pos,
            "obj_rot": zeros3,
            "obj_velp": zeros3,
            "grasped": torch.zeros(n, dtype=torch.bool, device=goal.device),
            "goal": goal,
        }
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        del draws
        a = torch.clamp(action.reshape(-1, 4).to(torch.float32), -1.0, 1.0)
        pos_ctrl, grip_ctrl = a[:, :3], a[:, 3]

        grip_pos = state["grip_pos"]
        new_grip = torch.minimum(torch.maximum(
            grip_pos + f32(_TRACK_GAIN * 0.05) * pos_ctrl, self._ws_lo), self._ws_hi)
        disp = new_grip - grip_pos
        grip_velp = _VELP_SCALE * disp  # the site velocity * dt convention

        # Fingers: a rate-limited servo toward qpos + ctrl (a relative
        # position actuator, mujoco_utils.ctrl_set_action).
        fingers = state["fingers"]
        if self.block_gripper:
            new_fingers = torch.zeros_like(fingers)
        else:
            target = torch.clamp(fingers + grip_ctrl[:, None] * _FINGER_MAX, 0.0, _FINGER_MAX)
            new_fingers = fingers + _FINGER_GAIN * (target - fingers)
        finger_vel = new_fingers - fingers

        obj_pos = state["obj_pos"]
        obj_velp = state["obj_velp"]
        grasped = state["grasped"]
        if self.has_object:
            # Grasp: fingers closing around a near object (PickAndPlace).
            if self.block_gripper:
                grasped = torch.zeros_like(grasped)
            else:
                near = norm(obj_pos - new_grip) < _GRASP_DIST
                closing = (grip_ctrl < 0.0) & (new_fingers[:, 0] < 0.03)
                keep = grasped & (new_fingers[:, 0] < 0.04)
                grasped = (near & closing) | keep
            # Push: project the object out of the gripper's contact disk.
            rel = obj_pos[:, :2] - new_grip[:, :2]
            dist_xy = norm(rel) + f32(1e-8)
            z_touch = torch.abs(new_grip[:, 2] - obj_pos[:, 2]) < 0.06
            pen = _PUSH_RADIUS - dist_xy
            # Open fingers straddle the object (no push): only a blocked
            # or closed gripper pushes.
            solid = True if self.block_gripper else new_fingers[:, 0] < 0.02
            pushed = ((pen > 0) & z_touch & ~grasped & solid)[:, None]
            push_vec = rel / dist_xy[:, None] * torch.clamp_min(pen, 0.0)[:, None]
            free_xy = obj_pos[:, :2] + torch.where(pushed, push_vec, 0.0)
            # Sliding with Coulomb decay (the Slide puck's momentum).
            decel = f32(float(self.config["object_friction_decel"]) * _DT)
            speed = norm(obj_velp[:, :2]) + f32(1e-8)
            new_speed = torch.clamp_min(speed - decel, 0.0)
            slide_vel = obj_velp[:, :2] * (new_speed / speed)[:, None]
            free_xy = free_xy + _DT * slide_vel
            new_velp_xy = slide_vel + torch.where(pushed, push_vec * inv(_DT), 0.0)
            height = torch.full_like(free_xy[:, :1], f32(self.height_offset))
            held = grasped[:, None]
            obj_pos = torch.where(held, new_grip, torch.cat([free_xy, height], 1))
            obj_velp = torch.where(held, disp * inv(_DT),
                                   torch.cat([new_velp_xy, torch.zeros_like(height)], 1))

        st = {
            "grip_pos": new_grip,
            "grip_velp": grip_velp,
            "fingers": new_fingers,
            "finger_vel": finger_vel,
            "obj_pos": obj_pos,
            "obj_rot": state["obj_rot"],
            "obj_velp": obj_velp,
            "grasped": grasped,
            "goal": state["goal"],
        }
        achieved = obj_pos if self.has_object else new_grip
        return EnvOut(state=st, obs=self._obs(st),
                      reward=self.compute_reward(achieved, state["goal"]),
                      terminated=torch.zeros_like(grasped))
