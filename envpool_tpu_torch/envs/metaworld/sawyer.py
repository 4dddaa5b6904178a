"""The Sawyer arm of the MetaWorld v3 family (50 tasks), batched in
PyTorch.

Counterpart of ``envpool_tpu/envs/metaworld/sawyer.py`` (reference:
``envpool/mujoco/metaworld/metaworld_env.h``), which models the arm at the
end effector as ``envs/robotics/fetch.py`` does:

* the action is 4 floats in [-1, 1]: an xyz mocap delta of 0.01 m a step
  clamped to the hand box, and the gripper's effort;
* the obs (39,) is ``[curr(18) = tcp(3), the gripper's open fraction(1),
  obj1 pos(3) + quat(4), obj2 pos(3) + quat(4); prev(18); goal(3)]``, the
  goal zeroed when ``partially_observable``;
* the infos: success, near_object, grasp_success, grasp_reward,
  in_place_reward, obj_to_target, unscaled_reward.

The object follows the JAX env's surrogate by category (a quasi-static
push, a grasp that attaches, a 1-dof articulation driven by the tcp; the
hammer and stick tasks carry a second body), and the reward is each
task's law: the reach, push and pick laws here, ten articulated laws in
:func:`_articulated_reward`, the others in ``exact_laws.py``.  All 50 tasks
share one class; the task's branch is chosen in Python once per pool.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut, TorchEnv
from ...core.rng import Draws
from ...core.specs import ArraySpec
from . import exact_laws
from .exact_laws import hamacher, inv, norm, vec
from .tasks import GOAL_DELTA, TASKS

__all__ = ["SawyerEnv"]

_STEP = 0.01
_HAND_LOW = np.asarray([-0.525, 0.348, -0.0525], np.float32)
_HAND_HIGH = np.asarray([0.525, 1.025, 0.7], np.float32)
_HAND_INIT = np.asarray([0.0, 0.6, 0.2], np.float32)
_GRASP_DIST = 0.05
_PUSH_RADIUS = 0.04
_ENGAGE_DIST = 0.06
# The Gaussian and long-tail sigmoids' scales at value_at_margin 0.1, in
# float32.
_GAUSS = float(np.sqrt(np.float32(-2.0) * np.log(np.float32(0.1))))
_LONG_TAIL = float(np.sqrt(np.float32(1.0 / 0.1 - 1.0)))
_PAD_HALF_CLOSED = 0.01
_PAD_HALF_OPEN = 0.05
_TARGET_RADIUS = 0.05


def _tolerance(d, margin):
    """Long-tail closeness in [0, 1]."""
    x = d * inv(margin)
    return 1.0 / (1.0 + x * x)


def tolerance_exact(d, bound, margin, lo=0.0, sigmoid="long_tail"):
    """metaworld reward_utils.tolerance (long_tail or gaussian, value 0.1
    at the margin): 1 inside ``[lo, bound]``; outside, of ``x`` the
    distance past the nearest bound over ``margin``."""
    below = d < lo
    above = d > bound
    x = torch.where(above, d - bound, lo - d) / torch.clamp_min(margin, 1e-8)
    if sigmoid == "gaussian":
        out = torch.exp(-0.5 * (x * _GAUSS) ** 2)
    else:
        out = 1.0 / ((x * _LONG_TAIL) ** 2 + 1.0)
    return torch.where(below | above, out, 1.0)


def gripper_caging_reward(tcp, grip, a_grip, obj, obj_init, *, obj_radius,
                          pad_success_thresh, xz_thresh, object_reach_radius, density):
    """metaworld SawyerXYZEnv._gripper_caging_reward: the object caged in y
    between the two finger pads (long-tail tolerances, Hamacher-combined),
    the tcp aligned with it in xz, the gripper's effort counted once caged
    (> 0.97), and the high and medium density blends."""
    half = _PAD_HALF_CLOSED + (_PAD_HALF_OPEN - _PAD_HALF_CLOSED) * grip
    left_pad_y = tcp[:, 1] + half
    right_pad_y = tcp[:, 1] - half
    pad_to_obj_l = torch.abs(left_pad_y - obj[:, 1])
    pad_to_obj_r = torch.abs(right_pad_y - obj[:, 1])
    left_margin = torch.abs(torch.abs(left_pad_y - obj_init[:, 1]) - pad_success_thresh)
    right_margin = torch.abs(torch.abs(right_pad_y - obj_init[:, 1]) - pad_success_thresh)
    left_caging = tolerance_exact(pad_to_obj_l, pad_success_thresh, left_margin, lo=obj_radius)
    right_caging = tolerance_exact(pad_to_obj_r, pad_success_thresh, right_margin,
                                   lo=obj_radius)
    y_caging = hamacher(left_caging, right_caging)

    hand0 = vec(_HAND_INIT, tcp)
    xz_margin = norm(obj_init[:, [0, 2]] - hand0[[0, 2]]) - xz_thresh
    xz_caging = tolerance_exact(norm(tcp[:, [0, 2]] - obj[:, [0, 2]]), xz_thresh, xz_margin)

    gripper_closed = torch.clamp(a_grip, 0.0, 1.0)
    caging = hamacher(y_caging, xz_caging)
    gripping = torch.where(caging > 0.97, gripper_closed, 0.0)
    caging_and_gripping = hamacher(caging, gripping)
    if density == "high":
        return (caging_and_gripping + caging) * 0.5
    if density == "medium":
        tcp_to_obj = norm(obj - tcp)
        reach_margin = torch.abs(norm(obj_init - hand0) - object_reach_radius)
        reach = tolerance_exact(tcp_to_obj, object_reach_radius, reach_margin)
        return (caging_and_gripping + reach) * 0.5
    return caging_and_gripping


# The articulated tasks whose published compute_reward law
# _articulated_reward computes.
_EXACT_ARTICULATED = frozenset({
    "button-press-v3", "button-press-topdown-v3", "coffee-button-v3",
    "drawer-open-v3", "drawer-close-v3", "faucet-open-v3",
    "faucet-close-v3", "window-open-v3", "window-close-v3",
    "handle-press-v3",
})


def _articulated_reward(name, tcp, grip, a, obj, obj0, goal):
    """``(reward_0_10, reach_like, in_place, target_d)`` of the published
    laws of SawyerButtonPressEnvV2, SawyerCoffeeButtonEnvV2,
    SawyerDrawerOpenEnvV2, SawyerDrawerCloseEnvV2,
    SawyerFaucetOpenEnvV2 (and Close), SawyerWindowOpenEnvV2 (and Close)
    and SawyerHandlePressEnvV2."""
    init_tcp = vec(_HAND_INIT, tcp)
    tcp_to_obj = norm(obj - tcp)
    tcp_to_obj_init = norm(obj0 - init_tcp)
    tcp_closed = torch.clamp(1.0 - grip, 0.0, 1.0)

    if name in ("button-press-v3", "button-press-topdown-v3"):
        # The press axis: y for the side press, z for topdown.
        dim = 1 if name == "button-press-v3" else 2
        obj_to_target = torch.abs(obj[:, dim] - goal[:, dim])
        obj_to_target_init = torch.abs(obj0[:, dim] - goal[:, dim])
        near_button = tolerance_exact(tcp_to_obj, 0.01, tcp_to_obj_init)
        button_pressed = tolerance_exact(obj_to_target, 0.005, obj_to_target_init)
        reward = 5.0 * hamacher(tcp_closed, near_button)
        reward = torch.where(tcp_to_obj <= 0.03, reward + 5.0 * button_pressed, reward)
        return reward, near_button, button_pressed, obj_to_target
    if name == "coffee-button-v3":
        obj_to_target = torch.abs(obj[:, 1] - goal[:, 1])
        obj_to_target_init = torch.abs(obj0[:, 1] - goal[:, 1])
        near_button = tolerance_exact(tcp_to_obj, 0.05, tcp_to_obj_init)
        button_pressed = tolerance_exact(obj_to_target, 0.005, obj_to_target_init)
        reward = 2.0 * hamacher(tcp_closed, near_button)
        reward = torch.where(tcp_to_obj <= 0.05, reward + 8.0 * button_pressed, reward)
        return reward, near_button, button_pressed, obj_to_target
    if name == "drawer-open-v3":
        # maxDist: the drawer's full travel; the caging error scaled (3, 3,
        # 1) so that lateral alignment dominates.
        max_dist = norm(goal - obj0)
        handle_error = norm(obj - goal)
        opening = tolerance_exact(handle_error, 0.02, max_dist)
        scale = vec((3.0, 3.0, 1.0), obj)
        caging = tolerance_exact(norm((obj - tcp) * scale), 0.01,
                                 norm((obj0 - init_tcp) * scale))
        return 5.0 * (caging + opening), caging, opening, handle_error
    if name == "drawer-close-v3":
        radius = 0.05
        target_to_obj = torch.abs(obj[:, 1] - goal[:, 1])
        target_to_obj_init = torch.abs(obj0[:, 1] - goal[:, 1])
        in_place = tolerance_exact(target_to_obj, radius, torch.abs(target_to_obj_init - radius))
        handle_radius = 0.005
        reach = tolerance_exact(tcp_to_obj, handle_radius,
                                torch.abs(tcp_to_obj_init - handle_radius), sigmoid="gaussian")
        reach = hamacher(reach, torch.clamp(a[:, 3], 0.0, 1.0))
        reward = hamacher(reach, in_place)
        reward = torch.where(target_to_obj <= radius + 0.015, 1.0, reward)
        return reward * 10.0, reach, in_place, target_to_obj
    if name in ("faucet-open-v3", "faucet-close-v3"):
        radius = 0.07
        target_to_obj = norm(obj - goal)
        target_to_obj_init = norm(obj0 - goal)
        in_place = tolerance_exact(target_to_obj, radius, torch.abs(target_to_obj_init - radius))
        reach_radius = 0.01
        reach = tolerance_exact(tcp_to_obj, reach_radius,
                                torch.abs(tcp_to_obj_init - reach_radius), sigmoid="gaussian")
        reward = (2.0 * reach + 3.0 * in_place) * 2.0
        reward = torch.where(target_to_obj <= radius, 10.0, reward)
        return reward, reach, in_place, target_to_obj
    if name in ("window-open-v3", "window-close-v3"):
        radius = 0.05
        target_to_obj = torch.abs(obj[:, 0] - goal[:, 0])
        target_to_obj_init = torch.abs(obj0[:, 0] - goal[:, 0])
        in_place = tolerance_exact(target_to_obj, radius, torch.abs(target_to_obj_init - radius))
        handle_radius = 0.02
        reach = tolerance_exact(tcp_to_obj, handle_radius,
                                torch.abs(tcp_to_obj_init - handle_radius), sigmoid="gaussian")
        return 10.0 * hamacher(reach, in_place), reach, in_place, target_to_obj
    if name == "handle-press-v3":
        radius = 0.02
        target_to_obj = torch.abs(obj[:, 2] - goal[:, 2])
        target_to_obj_init = torch.abs(obj0[:, 2] - goal[:, 2])
        in_place = tolerance_exact(target_to_obj, radius, torch.abs(target_to_obj_init - radius))
        handle_radius = 0.02
        reach = tolerance_exact(tcp_to_obj, handle_radius,
                                torch.abs(tcp_to_obj_init - handle_radius))
        reward = hamacher(reach, in_place)
        reward = torch.where(target_to_obj <= radius, 1.0, reward)
        return reward * 10.0, reach, in_place, target_to_obj
    raise KeyError(name)


def _dot(v, axis):
    return (v * axis).sum(-1)


class SawyerEnv(TorchEnv):
    """All 50 MetaWorld tasks by the ``task_name`` config key."""

    DEFAULT_CONFIG = {
        "reward_threshold": 10.0,
        "task_name": "reach-v3",
        "partially_observable": True,
    }

    def __init__(self, config):
        super().__init__(config)
        name = str(config["task_name"])
        self.task_name = name
        (self.category, obj_lo, obj_hi, goal_lo, goal_hi, self.thr, axis) = TASKS[name]
        self.obj_lo = np.asarray(obj_lo, np.float32)
        self.obj_hi = np.asarray(obj_hi, np.float32)
        # 1-dof tasks: the goal is the articulated displacement's target.
        self.goal_lo = np.asarray(goal_lo if goal_lo is not None else obj_lo, np.float32)
        self.goal_hi = np.asarray(goal_hi if goal_hi is not None else obj_hi, np.float32)
        self.axis = np.asarray(axis, np.float32) if axis is not None else None
        # The reference reset law's goal geometry overrides the category's
        # axis and travel where known (tasks.GOAL_DELTA).
        delta = GOAL_DELTA.get(name)
        if delta is not None:
            delta = np.asarray(delta, np.float32)
            self.travel = float(np.linalg.norm(delta))
            self.axis = delta / self.travel
        else:
            self.travel = None
        self.articulated = self.category in ("press", "turn", "slide")
        if self.articulated:
            mag = self.travel if self.travel is not None else {
                "press": 0.05, "slide": 0.12, "turn": 0.15}[self.category]
            # axis * mag as XLA folds the constant (float32).
            self._reach = (self.axis * np.float32(mag)).astype(np.float32)
        self.rest_quat = np.asarray(
            exact_laws.REST_QUAT.get(name, (1.0, 0.0, 0.0, 0.0)), np.float32)
        self.partially_observable = bool(config["partially_observable"])
        self.two_body = name in exact_laws.TWO_BODY
        # Whether the task's law gives the reward on the 0-10 scale.
        self.law_scale = (name in exact_laws.LAWS or name in _EXACT_ARTICULATED
                          or name == "handle-press-side-v3"
                          or self.category in ("push", "pick"))
        dev = self.device
        self._tcp0 = torch.as_tensor(_HAND_INIT, device=dev)
        self._lo = torch.as_tensor(_HAND_LOW, device=dev)
        self._hi = torch.as_tensor(_HAND_HIGH, device=dev)
        self._quat0 = torch.as_tensor(self.rest_quat, device=dev)
        if self.axis is not None:
            self._axis = torch.as_tensor(self.axis, device=dev)
        if self.articulated:
            self._reach_t = torch.as_tensor(self._reach, device=dev)

    # -- specs ------------------------------------------------------------------

    def state_spec(self):
        inf = float("inf")
        return {
            "obs": ArraySpec(np.float32, (39,), -inf, inf),
            "info:success": ArraySpec(np.float32, (), 0.0, 1.0),
            "info:near_object": ArraySpec(np.float32, ()),
            "info:grasp_success": ArraySpec(np.float32, (), 0.0, 1.0),
            "info:grasp_reward": ArraySpec(np.float32, ()),
            "info:in_place_reward": ArraySpec(np.float32, ()),
            "info:obj_to_target": ArraySpec(np.float32, ()),
            "info:unscaled_reward": ArraySpec(np.float32, ()),
        }

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (4,), -1.0, 1.0)}

    # -- helpers ----------------------------------------------------------------

    def _max_disp(self, obj0):
        """``|target(obj0) - obj0|``, per env as the JAX env computes it."""
        return norm((obj0 + self._reach_t) - obj0)

    def _curr_frame(self, st):
        n = st["tcp"].shape[0]
        if self.two_body:
            # hammer: the nail; the stick tasks: the container or handle,
            # with a zero quat.
            second = torch.cat([st["obj2_pos"], st["tcp"].new_zeros(n, 4)], 1)
        else:
            second = st["tcp"].new_zeros(n, 7)
        return torch.cat([st["tcp"], st["grip"][:, None], st["obj_pos"], st["obj_quat"],
                          second], 1)

    def _obs(self, st):
        curr = self._curr_frame(st)
        goal = torch.zeros_like(st["goal"]) if self.partially_observable else st["goal"]
        if self.category == "reach":
            d = norm(st["tcp"] - st["goal"])
        else:
            d = norm(st["obj_pos"] - st["goal"])
        near = norm(st["tcp"] - st["obj_pos"]) < _ENGAGE_DIST
        return {
            "obs": torch.cat([curr, st["prev"], goal], 1),
            "info:success": (d < self.thr).to(torch.float32),
            "info:near_object": near.to(torch.float32),
            "info:grasp_success": st["grasped"].to(torch.float32),
            "info:grasp_reward": st["grasp_reward"],
            "info:in_place_reward": st["in_place_reward"],
            "info:obj_to_target": d,
            "info:unscaled_reward": st["unscaled_reward"],
        }

    # -- reset --------------------------------------------------------------------

    def plan_reset(self, d):
        """The reset's draws, in the JAX env's order: the object between its
        bounds, then (unless articulated) the goal between its bounds."""
        d.uniform("obj", (3,), self.obj_lo, self.obj_hi)
        if not self.articulated:
            d.uniform("goal", (3,), self.goal_lo, self.goal_hi)

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    def reset_env(self, draws):
        obj = draws["obj"]
        n = obj.shape[0]
        goal = obj + self._reach_t if self.articulated else draws["goal"]
        if self.two_body:
            spawn = exact_laws.TWO_BODY[self.task_name]
            obj2 = goal if spawn is None else vec(spawn, obj).expand(n, 3).clone()
        else:
            obj2 = torch.zeros_like(obj)
        zero = obj.new_zeros(n)
        st = {
            "tcp": self._tcp0.expand(n, 3).clone(),
            "grip": torch.ones_like(zero),  # the open fraction
            "obj_pos": obj,
            "obj_quat": self._quat0.expand(n, 4).clone(),
            "obj0": obj,
            "obj2_pos": obj2,
            "obj2_0": obj2,
            "goal": goal,
            "grasped": torch.zeros(n, dtype=torch.bool, device=obj.device),
            "prev": obj.new_zeros(n, 18),
            "grasp_reward": zero,
            "in_place_reward": zero,
            "unscaled_reward": zero,
        }
        st["prev"] = self._curr_frame(st)
        return st, self._obs(st)

    # -- step -----------------------------------------------------------------------

    def step_env(self, state, action, draws):
        del draws
        a = torch.clamp(action.reshape(-1, 4).to(torch.float32), -1, 1)
        prev_curr = self._curr_frame(state)
        tcp = torch.minimum(torch.maximum(state["tcp"] + a[:, :3] * _STEP, self._lo), self._hi)
        # The gripper: an effort in [-1, 1] drives the open fraction.
        grip = torch.clamp(state["grip"] - 0.4 * a[:, 3], 0.0, 1.0)

        obj = state["obj_pos"]
        obj0 = state["obj0"]
        grasped = state["grasped"]
        near = norm(obj - tcp) < _GRASP_DIST
        if self.category == "pick":
            closing = (a[:, 3] > 0.0) & (grip < 0.6)
            keep = grasped & (grip < 0.7)
            grasped = (near & closing) | keep
            obj = torch.where(grasped[:, None], tcp, obj)
        elif self.category == "push":
            # A quasi-static horizontal push (the object stays at its height).
            rel = obj[:, :2] - tcp[:, :2]
            dist = norm(rel) + 1e-8
            z_touch = torch.abs(tcp[:, 2] - obj[:, 2]) < 0.05
            pen = _PUSH_RADIUS - dist
            pushed = ((pen > 0) & z_touch)[:, None]
            new_xy = obj[:, :2] + torch.where(pushed, rel / dist[:, None] * pen[:, None], 0.0)
            obj = torch.cat([new_xy, obj[:, 2:]], 1)
        elif self.articulated:
            # A 1-dof articulation: the displacement along the axis tracks
            # the tcp's motion while engaged near the handle; a press also
            # moves when pushed past its face.
            engaged = norm(obj - tcp) < _ENGAGE_DIST
            tcp_d = _dot(tcp - state["tcp"], self._axis)
            if self.category == "press":
                tcp_d = torch.clamp_min(tcp_d, 0.0)
            drive = torch.where(engaged, tcp_d, 0.0)
            disp = _dot(obj - obj0, self._axis)
            disp = torch.minimum(torch.clamp_min(disp + drive, 0.0), self._max_disp(obj0))
            obj = obj0 + self._axis * disp[:, None]

        # The second body (the hammer's nail, the stick's container).
        obj2 = state["obj2_pos"]
        moved = obj - state["obj_pos"]
        if self.task_name == "hammer-v3":
            head_off = vec((0.16, 0.06, 0.0), obj)
            head = obj + head_off
            near_nail = norm(head - obj2) < 0.05
            drive = torch.clamp_min((head - (state["obj_pos"] + head_off))[:, 1], 0.0)
            disp = (obj2 - state["obj2_0"])[:, 1]
            disp = torch.clamp_max(disp + torch.where(near_nail, drive, 0.0), 0.12)
            obj2_0 = state["obj2_0"]
            obj2 = torch.stack([obj2_0[:, 0], obj2_0[:, 1] + disp, obj2_0[:, 2]], 1)
        elif self.task_name == "stick-push-v3":
            engaged = norm(obj - obj2) < 0.07
            delta = torch.cat([moved[:, :2], torch.zeros_like(moved[:, 2:])], 1)
            obj2 = torch.where(engaged[:, None], obj2 + delta, obj2)
        elif self.task_name == "stick-pull-v3":
            end = obj + vec((0.12, 0.0, 0.0), obj)
            inserted = ((end[:, 0] >= obj2[:, 0])
                        & (torch.abs(end[:, 1] - obj2[:, 1]) <= 0.040)
                        & (torch.abs(end[:, 2] - obj2[:, 2]) <= 0.060))
            obj2 = torch.where(inserted[:, None], obj2 + moved, obj2)

        unscaled, grasp_reward, in_place, target_d = self._reward(state, tcp, grip, a, obj, obj2)
        if self.category == "reach":
            reward = unscaled * 10.0  # metaworld reach has no override
        elif self.law_scale:
            reward = unscaled  # the law is already on the 0-10 scale
        else:
            reward = torch.where(target_d < self.thr, 10.0, unscaled * 10.0)
        st = {
            "tcp": tcp,
            "grip": grip,
            "obj_pos": obj,
            "obj_quat": state["obj_quat"],
            "obj0": obj0,
            "obj2_pos": obj2,
            "obj2_0": state["obj2_0"],
            "goal": state["goal"],
            "grasped": grasped,
            "prev": prev_curr,
            "grasp_reward": grasp_reward,
            "in_place_reward": in_place,
            "unscaled_reward": unscaled,
        }
        return EnvOut(state=st, obs=self._obs(st), reward=reward,
                      terminated=torch.zeros_like(grasped))

    def _reward(self, state, tcp, grip, a, obj, obj2):
        """``(unscaled, grasp_reward, in_place, target_d)`` of the task's
        law (the reach/caging and in-place structure of the reference)."""
        goal, obj0 = state["goal"], state["obj0"]
        name = self.task_name
        tcp_to_obj = norm(tcp - obj)
        zero = torch.zeros_like(tcp_to_obj)
        if self.category == "reach":
            # SawyerReachEnvV2.compute_reward: 10 * tolerance(|tcp - target|,
            # bounds (0, 0.05), margin |hand_init - target|, long tail).
            target_d = norm(tcp - goal)
            in_place = tolerance_exact(target_d, 0.05, norm(vec(_HAND_INIT, goal) - goal))
            return in_place, zero, in_place, target_d
        if name in exact_laws.LAWS:
            if self.articulated:
                disp_frac = torch.clamp(
                    _dot(obj - obj0, self._axis) / torch.clamp_min(self._max_disp(obj0), 1e-8),
                    0.0, 1.0)
            else:
                disp_frac = zero
            ctx = {"tcp": tcp, "grip": grip, "a": a, "obj": obj, "obj0": obj0, "goal": goal,
                   "prev_tcp": state["tcp"], "quat": state["obj_quat"],
                   "disp_frac": disp_frac, "obj2": obj2, "obj2_0": state["obj2_0"]}
            return exact_laws.LAWS[name](ctx)
        if name == "handle-press-side-v3":
            # The published law of handle-press (cases 23/24 share it).
            return _articulated_reward("handle-press-v3", tcp, grip, a, obj, obj0, goal)
        if self.category == "push":
            # SawyerPushEnvV2.compute_reward: 2 * caging, tripled plus one with
            # 5 * in_place once the tcp touches the object with the gripper
            # open, 10 inside the target radius.
            target_d = norm(obj - goal)
            in_place = tolerance_exact(target_d, _TARGET_RADIUS, norm(obj0 - goal))
            grasp_reward = gripper_caging_reward(
                tcp, grip, a[:, 3], obj, obj0, obj_radius=0.015, pad_success_thresh=0.05,
                xz_thresh=0.005, object_reach_radius=0.01, density="high")
            r = 2.0 * grasp_reward
            touch = (tcp_to_obj < 0.02) & (grip > 0.0)
            r = torch.where(touch, r + 1.0 + r + 5.0 * in_place, r)
            r = torch.where(target_d < _TARGET_RADIUS, 10.0, r)
            return r, grasp_reward, in_place, target_d
        if self.category == "pick":
            # SawyerPickPlaceEnvV2.compute_reward: hamacher(caging, in_place),
            # plus 1 + 5 * in_place once touched, open and lifted 1 cm, 10
            # inside the target radius.
            target_d = norm(obj - goal)
            in_place = tolerance_exact(target_d, _TARGET_RADIUS, norm(obj0 - goal))
            grasp_reward = gripper_caging_reward(
                tcp, grip, a[:, 3], obj, obj0, obj_radius=0.015, pad_success_thresh=0.05,
                xz_thresh=0.005, object_reach_radius=0.01, density=None)
            r = hamacher(grasp_reward, in_place)
            lifted = obj[:, 2] - 0.01 > obj0[:, 2]
            touch = (tcp_to_obj < 0.02) & (grip > 0.0) & lifted
            r = torch.where(touch, r + 1.0 + 5.0 * in_place, r)
            r = torch.where(target_d < _TARGET_RADIUS, 10.0, r)
            return r, grasp_reward, in_place, target_d
        if name in _EXACT_ARTICULATED:
            return _articulated_reward(name, tcp, grip, a, obj, obj0, goal)
        target_d = norm(obj - goal)
        reach = _tolerance(tcp_to_obj, 0.08)
        in_place = _tolerance(target_d, 0.1)
        return hamacher(reach, in_place), reach, in_place, target_d
