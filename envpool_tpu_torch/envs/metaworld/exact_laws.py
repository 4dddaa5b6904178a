"""Per-task MetaWorld compute_reward laws over a batch of envs.

Counterpart of ``envpool_tpu/envs/metaworld/exact_laws.py`` (the per-task
``ComputeReward`` cases of ``envpool/mujoco/metaworld/metaworld_env.h``,
which mirror the published metaworld v2/v3 ``compute_reward``): each law
takes the context ``c`` of one step as ``[N, ...]`` tensors (``tcp``,
``grip`` the gripper's open fraction, ``a`` the action, ``obj`` and ``obj0``
the tracked point and its reset position, ``goal``, ``quat``,
``disp_frac`` the articulation fraction, ``obj2`` and ``obj2_0`` the
second body) and returns ``(reward_0_10, grasp_like, in_place,
target_d)``, each ``[N]``.  A division by a constant is a multiplication
by its float32 reciprocal, as XLA computes the JAX laws.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.batched import const, inv, norm

_PI = float(np.pi)
_HAND_INIT = (0.0, 0.6, 0.2)
_PAD_HALF_CLOSED = 0.01
_PAD_HALF_OPEN = 0.05
# Pads at reset: hand at _HAND_INIT, gripper fully open (half = 0.05).
_INIT_LEFT_PAD = (0.0, 0.65, 0.2)
_INIT_RIGHT_PAD = (0.0, 0.55, 0.2)
# sqrt(-2 ln 0.1): the Gaussian sigmoid's scale at value_at_margin 0.1.
_GAUSS_SCALE = float(np.sqrt(-2.0 * np.log(0.1)))


def vec(values, like: torch.Tensor) -> torch.Tensor:
    """A constant vector on ``like``'s device."""
    return const(tuple(float(v) for v in values), like.device)


def set_col(v: torch.Tensor, i: int, x) -> torch.Tensor:
    """``v`` with column ``i`` replaced by ``x`` (``.at[..., i].set``)."""
    out = v.clone()
    out[:, i] = x
    return out


def hamacher(a, b):
    """metaworld reward_utils.hamacher_product."""
    denom = a + b - a * b
    return torch.where(denom > 0, a * b / denom, 0.0)


def _over(d, margin):
    """``d / margin`` where ``margin > 0``, else ``d`` (``d / where(margin >
    0, margin, 1)``); a constant margin is a multiplication by its
    reciprocal."""
    if isinstance(margin, (int, float)):
        return d * inv(margin) if margin > 0 else d
    return d / torch.where(margin > 0, margin, 1.0)


def _outside(x, lower, upper):
    return torch.where(x < lower, lower - x, x - upper)


def _in_bounds(x, lower, upper, out):
    return torch.where((x >= lower) & (x <= upper), 1.0, out)


def longtail(x, lower, upper, margin):
    """metaworld_env.h:254-268 LongTailTolerance (value_at_margin 0.1)."""
    scaled = _over(3.0 * _outside(x, lower, upper), margin)
    out = 1.0 / (scaled * scaled + 1.0)
    if isinstance(margin, (int, float)):
        out = out if margin > 0 else torch.zeros_like(out)
    else:
        out = torch.where(margin > 0, out, 0.0)
    return _in_bounds(x, lower, upper, out)


def gaussian(x, lower, upper, margin):
    """metaworld_env.h:278-289 GaussianTolerance."""
    d = _over(_outside(x, lower, upper), margin)
    out = torch.exp(-0.5 * (d * _GAUSS_SCALE) ** 2)
    if isinstance(margin, (int, float)):
        out = out if margin > 0 else torch.zeros_like(out)
    else:
        out = torch.where(margin > 0, out, 0.0)
    return _in_bounds(x, lower, upper, out)


def _dist2(a, b):
    """The xy-plane distance (the reference's ``Distance2``)."""
    return norm(a[:, :2] - b[:, :2])


def _dscaled(a, b, s):
    return norm((a - b) * vec(s, a))


def pads(tcp, grip):
    """The finger pads' positions from the surrogate pad model."""
    half = _PAD_HALF_CLOSED + (_PAD_HALF_OPEN - _PAD_HALF_CLOSED) * grip
    return set_col(tcp, 1, tcp[:, 1] + half), set_col(tcp, 1, tcp[:, 1] - half)


def _xz(v):
    return v[:, [0, 2]]


def caging(c, obj_pos, obj_radius, pad_success_thresh, object_reach_radius, xz_thresh,
           desired_effort=1.0, high_density=False, medium_density=False, init_obj=None,
           signed_y=False, grip_success_extra=-1.0, caging_threshold=0.97):
    """metaworld_env.h:1478-1547 GripperCagingReward, all options."""
    initial_obj = c["obj0"] if init_obj is None else init_obj
    left_pad, right_pad = pads(c["tcp"], c["grip"])
    if signed_y:
        left_delta = left_pad[:, 1] - obj_pos[:, 1]
        right_delta = obj_pos[:, 1] - right_pad[:, 1]
    else:
        left_delta = torch.abs(left_pad[:, 1] - obj_pos[:, 1])
        right_delta = torch.abs(right_pad[:, 1] - obj_pos[:, 1])
    left_margin = torch.abs(torch.abs(left_pad[:, 1] - initial_obj[:, 1]) - pad_success_thresh)
    right_margin = torch.abs(torch.abs(right_pad[:, 1] - initial_obj[:, 1])
                             - pad_success_thresh)
    left_caging = longtail(left_delta, obj_radius, pad_success_thresh, left_margin)
    right_caging = longtail(right_delta, obj_radius, pad_success_thresh, right_margin)
    y_caging = hamacher(left_caging, right_caging)

    init_tcp = vec(_HAND_INIT, obj_pos)
    xz_margin = norm(_xz(initial_obj) - init_tcp[[0, 2]]) - xz_thresh
    xz_caging = longtail(norm(_xz(c["tcp"]) - _xz(obj_pos)), 0.0, xz_thresh, xz_margin)
    cage = hamacher(y_caging, xz_caging)
    gripper_closed = torch.clamp(c["a"][:, 3], 0.0, desired_effort) * inv(desired_effort)
    if grip_success_extra >= 0.0:
        grip_margin = obj_radius + grip_success_extra
        lg = longtail(left_delta, obj_radius, grip_margin, left_margin)
        rg = longtail(right_delta, obj_radius, grip_margin, right_margin)
        gripping = torch.where(cage > caging_threshold, hamacher(lg, rg), 0.0)
        out = (cage + gripping) * 0.5
    else:
        gripping = torch.where(cage > caging_threshold, gripper_closed, 0.0)
        out = hamacher(cage, gripping)
    if high_density:
        out = (out + cage) * 0.5
    if medium_density:
        tcp_to_obj = norm(obj_pos - c["tcp"])
        tcp_to_obj_init = norm(initial_obj - init_tcp)
        reach_margin = torch.abs(tcp_to_obj_init - object_reach_radius)
        reach = longtail(tcp_to_obj, 0.0, object_reach_radius, reach_margin)
        out = (out + reach) * 0.5
    return out


def _sweep_caging(c, obj_pos, obj_radius, grip_success_extra, xz_thresh):
    """metaworld_env.h:1583-1619 SweepStyleCagingReward (margins from the
    current object y against the initial pad y, signed deltas)."""
    pad_success_margin = 0.05
    grip_success_margin = obj_radius + grip_success_extra
    left_pad, right_pad = pads(c["tcp"], c["grip"])
    left_delta = left_pad[:, 1] - obj_pos[:, 1]
    right_delta = obj_pos[:, 1] - right_pad[:, 1]
    right_margin = torch.abs(torch.abs(obj_pos[:, 1] - _INIT_RIGHT_PAD[1]) - pad_success_margin)
    left_margin = torch.abs(torch.abs(obj_pos[:, 1] - _INIT_LEFT_PAD[1]) - pad_success_margin)
    rc = longtail(right_delta, obj_radius, pad_success_margin, right_margin)
    lc = longtail(left_delta, obj_radius, pad_success_margin, left_margin)
    rg = longtail(right_delta, obj_radius, grip_success_margin, right_margin)
    lg = longtail(left_delta, obj_radius, grip_success_margin, left_margin)
    y_caging = hamacher(rc, lc)
    y_gripping = hamacher(rg, lg)
    init_tcp = vec(_HAND_INIT, obj_pos)
    xz_margin = norm(_xz(c["obj0"]) - init_tcp[[0, 2]]) - xz_thresh
    xz_caging = longtail(norm(_xz(c["tcp"]) - _xz(obj_pos)), 0.0, xz_thresh, xz_margin)
    cage = hamacher(y_caging, xz_caging)
    gripping = torch.where(cage > 0.95, y_gripping, 0.0)
    return (cage + gripping) * 0.5


def _log_floor(radius, thresh, k, b):
    """The log-barrier floor's height of bin-picking, box-close, door-open
    and pick-out-of-hole (metaworld_env.h:1742-1748)."""
    return torch.where(radius <= thresh, 0.0,
                       k * torch.log(torch.clamp_min(radius - thresh, 1e-9)) + b)


def _above(hand_z, floor, margin, clamp=False):
    """1 above the floor, else the long tail of the depth below it."""
    depth = floor - hand_z
    if clamp:
        depth = torch.clamp_min(depth, 0.0)
    return torch.where(hand_z >= floor, 1.0, longtail(depth, 0.0, 0.01, margin))


def _f(mask):
    return mask.to(torch.float32)


# ---------------------------------------------------------------------------
# The per-task laws (case numbers cite metaworld_env.h's ComputeReward).
# ---------------------------------------------------------------------------


def _law_basketball(c):  # case 1
    target = set_col(c["goal"], 2, 0.3)
    target_to_obj = _dscaled(c["obj"], target, (1.0, 1.0, 2.0))
    target_to_obj_init = _dscaled(c["obj0"], target, (1.0, 1.0, 2.0))
    in_place = longtail(target_to_obj, 0.0, 0.08, target_to_obj_init)
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    grasped = caging(c, c["obj"], 0.025, 0.06, 0.01, 0.005, 1.0, True)
    lifted = ((tcp_to_obj < 0.035) & (c["grip"] > 0.0)
              & (c["obj"][:, 2] - 0.01 > c["obj0"][:, 2]))
    grasped = torch.where(lifted, 1.0, grasped)
    reward = hamacher(grasped, in_place)
    reward = torch.where(lifted, reward + 1.0 + 5.0 * in_place, reward)
    reward = torch.where(target_to_obj < 0.08, 10.0, reward)
    return reward, grasped, in_place, target_to_obj


def _law_bin_picking(c):  # case 2
    obj_to_target = norm(c["obj"] - c["goal"])
    in_place = longtail(obj_to_target, 0.0, 0.05, norm(c["obj0"] - c["goal"]))
    hand = c["tcp"]
    r0 = _dist2(hand, c["obj0"])
    r1 = _dist2(hand, c["goal"])
    floor = torch.minimum(_log_floor(r0, 0.03, 0.02, 0.2), _log_floor(r1, 0.03, 0.02, 0.2))
    above_floor = _above(hand[:, 2], floor, 0.05, clamp=True)
    grasped = caging(c, c["obj"], 0.015, 0.05, 0.01, 0.01, 0.7, True)
    reward = hamacher(grasped, in_place)
    near = norm(c["obj"] - hand) < 0.04
    pinched = c["grip"] < 0.43
    lifted = c["obj"][:, 2] - 0.02 > c["obj0"][:, 2]
    grasp_success = near & lifted & ~pinched
    reward = torch.where(grasp_success, reward + 1.0 + 5.0 * hamacher(above_floor, in_place),
                         reward)
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)
    return reward, grasped, in_place, obj_to_target


def _quat_reward(q, w, scale):
    """``max(1 - |q - (w, 0, 0, w)...| / scale, 0)``: the quat-error term."""
    err = norm(q - vec(w, q))
    return torch.clamp_min(1.0 - err * inv(scale), 0.0)


def _law_box_close(c):  # case 3
    reward_grab = torch.clamp((torch.clamp(c["a"][:, 3], -1.0, 1.0) + 1.0) * 0.5, 0.0, 1.0)
    reward_quat = _quat_reward(c["quat"], (0.707, 0.0, 0.0, 0.707), 0.2)
    lid = c["obj"] + vec((0.0, 0.0, 0.02), c["obj"])
    hand = c["tcp"]
    radius = _dist2(hand, lid)
    floor = _log_floor(radius, 0.02, 0.04, 0.4)
    above_floor = _above(hand[:, 2], floor, floor * 0.5)
    in_place = longtail(norm(hand - lid), 0.0, 0.02, 0.5)
    ready = hamacher(above_floor, in_place)
    pos_error = _dscaled(c["goal"], lid, (1.0, 1.0, 3.0))
    lifted = 0.2 * _f(lid[:, 2] > 0.04) + 0.8 * longtail(pos_error, 0.0, 0.05, 0.25)
    reward = 2.0 * hamacher(reward_grab, ready) + 8.0 * lifted
    success = norm(c["obj"] - c["goal"]) < 0.08
    reward = torch.where(success, 10.0, reward)
    reward = reward * reward_quat
    return reward, reward_grab, lifted, norm(c["obj"] - c["goal"])


def _law_button_topdown_wall(c):  # case 4/5 (the topdown law)
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    tcp_to_obj_init = norm(c["obj"] - vec(_HAND_INIT, c["obj"]))
    obj_to_target = torch.abs(c["goal"][:, 2] - c["obj"][:, 2])
    obj_to_target_init = torch.abs(c["goal"][:, 2] - c["obj0"][:, 2])
    tcp_closed = 1.0 - c["grip"]
    near = longtail(tcp_to_obj, 0.0, 0.01, tcp_to_obj_init)
    pressed = longtail(obj_to_target, 0.0, 0.005, obj_to_target_init)
    reward = 5.0 * hamacher(tcp_closed, near)
    reward = torch.where(tcp_to_obj <= 0.03, reward + 5.0 * pressed, reward)
    return reward, near, pressed, obj_to_target


def _law_button_wall(c):  # case 7
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    near = longtail(tcp_to_obj, 0.0, 0.01, norm(c["obj"] - vec(_HAND_INIT, c["obj"])))
    obj_to_target = torch.abs(c["goal"][:, 1] - c["obj"][:, 1])
    obj_to_target_init = torch.abs(c["goal"][:, 1] - c["obj0"][:, 1])
    pressed = longtail(obj_to_target, 0.0, 0.005, obj_to_target_init)
    far = 2.0 * hamacher((1.0 - c["grip"]) * 0.5, near)
    close = 2.0 + 2.0 * (1.0 + c["grip"]) + 4.0 * pressed * pressed
    reward = torch.where(tcp_to_obj > 0.07, far, close)
    return reward, near, pressed, obj_to_target


def _law_coffee_push_pull(c):  # cases 9/10 (one law)
    scaled_to_target = _dscaled(c["obj"], c["goal"], (2.0, 2.0, 1.0))
    scaled_init = _dscaled(c["obj0"], c["goal"], (2.0, 2.0, 1.0))
    in_place = longtail(scaled_to_target, 0.0, 0.05, scaled_init)
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    grasped = caging(c, c["obj"], 0.02, 0.05, 0.04, 0.05, 0.7, False, True)
    reward = hamacher(grasped, in_place)
    touch = (tcp_to_obj < 0.04) & (c["grip"] > 0.0)
    reward = torch.where(touch, reward + 1.0 + 5.0 * in_place, reward)
    reward = torch.where(scaled_to_target < 0.05, 10.0, reward)
    return reward, grasped, in_place, norm(c["obj"] - c["goal"])


def _law_dial_turn(c):  # case 11
    # Surrogate: ``obj`` is the dial-rim point the reference composes from
    # the dial body and knob angle; handle_init == obj0.
    obj_to_target = norm(c["obj"] - c["goal"])
    init_margin = torch.abs(norm(c["obj0"] - c["goal"]) - 0.07)
    in_place = longtail(obj_to_target, 0.0, 0.07, init_margin)
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    reach = gaussian(tcp_to_obj, 0.0, 0.005,
                     torch.abs(norm(c["obj0"] - vec(_HAND_INIT, c["obj0"])) - 0.005))
    reach = hamacher(reach, torch.clamp(c["a"][:, 3], 0.0, 1.0))
    reward = 10.0 * hamacher(reach, in_place)
    return reward, reach, in_place, obj_to_target


def _law_assembly(c, disassemble=False):  # cases 0 / 12
    hand = c["tcp"]
    wrench = c["obj"]
    wrench = set_col(wrench, 0, torch.where(torch.abs(wrench[:, 0] - hand[:, 0]) < 0.01,
                                            hand[:, 0], wrench[:, 0]))
    wrench_center = c["obj"]  # surrogate: the nut's centre is the tracked point
    reward_quat = _quat_reward(c["quat"], (0.707, 0.0, 0.0, 0.707), 0.4)
    # assembly: medium density; disassemble: high density (cases 0/12).
    reward_grab = caging(c, wrench, 0.015, 0.02, 0.01, 0.01, 1.0,
                         high_density=disassemble, medium_density=not disassemble)
    zero = torch.zeros_like(reward_grab)
    if disassemble:
        pos_error = (c["goal"] + vec((0.0, 0.0, 0.1), c["goal"])) - wrench_center
        in_place = (0.1 * _f(wrench_center[:, 2] > 0.02)
                    + 0.9 * longtail(norm(pos_error), 0.0, 0.02, 0.2))
        success = c["obj"][:, 2] > c["goal"][:, 2]
        reward = (2.0 * reward_grab + 6.0 * in_place) * reward_quat
        reward = torch.where(success, 10.0, reward)
        return reward, reward_grab, in_place, zero
    pos_error = c["goal"] - wrench_center
    radius = norm(pos_error[:, :2])
    aligned = radius < 0.02
    hooked = pos_error[:, 2] > 0.0
    success = aligned & hooked
    threshold = torch.where(success, 0.02, 0.01)
    target_height = torch.where(
        radius > threshold,
        0.02 * torch.log(torch.clamp_min(radius - threshold, 1e-9)) + 0.2, 0.0)
    pe = set_col(pos_error, 2, target_height - wrench_center[:, 2])
    lifted = (wrench_center[:, 2] > 0.02) | (radius < threshold)
    in_place = (0.1 * _f(lifted)
                + 0.9 * longtail(norm(pe * vec((1.0, 1.0, 3.0), pe)), 0.0, 0.02, 0.4))
    reward = (2.0 * reward_grab + 6.0 * in_place) * reward_quat
    reward = torch.where(success, 10.0, reward)
    return reward, reward_grab, in_place, zero


def _law_door_close(c):  # case 13
    obj_to_target = norm(c["obj"] - c["goal"])
    in_place = gaussian(obj_to_target, 0.0, 0.05, norm(c["obj0"] - c["goal"]))
    tcp_to_target = norm(c["tcp"] - c["goal"])
    hand_margin = norm(vec(_HAND_INIT, c["obj"]) - c["obj"]) + 0.1
    hand_in_place = gaussian(tcp_to_target, 0.0, 0.25 * 0.05, hand_margin)
    reward = 3.0 * hand_in_place + 6.0 * in_place
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)
    return reward, hand_in_place, in_place, obj_to_target


def _law_door_lock(c):  # case 14
    left_pad, _ = pads(c["tcp"], c["grip"])
    tcp_to_obj = _dscaled(c["obj"], left_pad, (0.25, 1.0, 0.5))
    tcp_to_obj_init = _dscaled(c["obj"], vec(_INIT_LEFT_PAD, c["obj"]), (0.25, 1.0, 0.5))
    obj_to_target = torch.abs(c["goal"][:, 2] - c["obj"][:, 2])
    near = longtail(tcp_to_obj, 0.0, 0.01, tcp_to_obj_init)
    pressed = longtail(obj_to_target, 0.0, 0.005, 0.1)
    reward = 2.0 * hamacher(torch.clamp_min(c["grip"], 0.0), near) + 8.0 * pressed
    return reward, near, pressed, obj_to_target


def _law_door_open(c):  # case 15
    hand = c["tcp"]
    reward_grab = (torch.clamp(c["a"][:, 3], -1.0, 1.0) + 1.0) * 0.5
    door = c["obj"] + vec((-0.05, 0.0, 0.0), c["obj"])
    radius = _dist2(hand, door)
    floor = _log_floor(radius, 0.12, 0.04, 0.4)
    above_floor = _above(hand[:, 2], floor, floor * 0.5)
    in_place = longtail(norm(hand - door - vec((0.05, 0.03, -0.01), hand)), 0.0, 0.06, 0.5)
    ready = hamacher(above_floor, in_place)
    # Surrogate: the hinge angle from the articulation fraction (the full
    # travel is the reference's fully open pi/2 + pi/6 swing).
    theta = -c["disp_frac"] * (_PI / 2.0 + _PI / 6.0)
    door_angle = -theta
    opened = (0.2 * _f(theta < -_PI / 90.0)
              + 0.8 * longtail((_PI / 2.0 + _PI / 6.0) - door_angle, 0.0, 0.5, _PI / 3.0))
    reward = 2.0 * hamacher(ready, reward_grab) + 8.0 * opened
    success = torch.abs(c["obj"][:, 0] - c["goal"][:, 0]) <= 0.08
    reward = torch.where(success, 10.0, reward)
    return reward, reward_grab, opened, torch.zeros_like(reward)


def _law_door_unlock(c):  # case 16
    shoulder = c["tcp"] + vec((0.0, 0.055, 0.07), c["tcp"])
    init_shoulder = vec(np.float32(_HAND_INIT) + np.float32((0.0, 0.055, 0.07)), c["tcp"])
    shoulder_to_lock = _dscaled(shoulder, c["obj"], (0.25, 1.0, 0.5))
    shoulder_init = _dscaled(init_shoulder.expand_as(c["obj0"]), c["obj0"], (0.25, 1.0, 0.5))
    ready = longtail(shoulder_to_lock, 0.0, 0.02, shoulder_init)
    obj_to_target = torch.abs(c["goal"][:, 0] - c["obj"][:, 0])
    pushed = longtail(obj_to_target, 0.0, 0.005, 0.1)
    reward = 2.0 * ready + 8.0 * pushed
    return reward, ready, pushed, obj_to_target


def _law_hand_insert(c):  # case 17
    obj_to_target = norm(c["obj"] - c["goal"])
    in_place = longtail(obj_to_target, 0.0, 0.05, norm(c["obj0"] - c["goal"]))
    grasped = caging(c, c["obj"], 0.015, 0.05, 0.01, 0.005, 1.0, True)
    reward = hamacher(grasped, in_place)
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    touch = (tcp_to_obj < 0.02) & (c["grip"] > 0.0)
    reward = torch.where(touch, reward + 1.0 + 7.0 * in_place, reward)
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)
    return reward, grasped, in_place, obj_to_target


def _law_handle_pull(c, side=False):  # cases 25/26
    if side:
        obj_to_target = norm(c["obj"] - c["goal"])
        init_d = norm(c["obj0"] - c["goal"])
    else:
        obj_to_target = torch.abs(c["goal"][:, 2] - c["obj"][:, 2])
        init_d = torch.abs(c["goal"][:, 2] - c["obj0"][:, 2])
    in_place = longtail(obj_to_target, 0.0, 0.05, init_d)
    grasped = caging(c, c["obj"], 0.032 if side else 0.022, 0.06 if side else 0.05,
                     0.01, 0.01, 1.0, True)
    reward = hamacher(grasped, in_place)
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    lifted = ((tcp_to_obj < 0.035) & (c["grip"] > 0.0)
              & (c["obj"][:, 2] - 0.01 > c["obj0"][:, 2]))
    reward = torch.where(lifted, reward + 1.0 + 5.0 * in_place, reward)
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)
    return reward, grasped, in_place, obj_to_target


def _law_lever_pull(c):  # case 27
    shoulder = c["tcp"] + vec((0.0, 0.055, 0.07), c["tcp"])
    init_shoulder = vec(np.float32(_HAND_INIT) + np.float32((0.0, 0.055, 0.07)), c["tcp"])
    shoulder_to_lever = _dscaled(shoulder, c["obj"], (4.0, 1.0, 4.0))
    shoulder_init = _dscaled(init_shoulder.expand_as(c["obj0"]), c["obj0"], (4.0, 1.0, 4.0))
    ready = longtail(shoulder_to_lever, 0.0, 0.02, shoulder_init)
    # Surrogate: the lever's angle from the articulation fraction (0 -> pi/2).
    lever_angle = c["disp_frac"] * (_PI / 2.0)
    lever_error = torch.abs(lever_angle - _PI / 2.0)
    engagement = longtail(lever_error, 0.0, _PI / 48.0, _PI / 2.0 - _PI / 12.0)
    in_place = longtail(norm(c["obj"] - c["goal"]), 0.0, 0.04, norm(c["obj0"] - c["goal"]))
    reward = 10.0 * hamacher(ready, in_place)
    return reward, ready, engagement, shoulder_to_lever


def _law_pick_place_wall(c):  # case 28
    goal = c["goal"]
    midpoint = torch.stack([goal[:, 0], torch.full_like(goal[:, 0], 0.77),
                            torch.full_like(goal[:, 0], 0.25)], 1)
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    obj_to_mid = _dscaled(c["obj"], midpoint, (1.0, 1.0, 3.0))
    mid_init = _dscaled(c["obj0"], midpoint, (1.0, 1.0, 3.0))
    part1 = longtail(obj_to_mid, 0.0, 0.05, mid_init)
    obj_to_target = norm(c["obj"] - goal)
    part2 = longtail(obj_to_target, 0.0, 0.05, norm(c["obj0"] - goal))
    grasped = caging(c, c["obj"], 0.015, 0.05, 0.01, 0.005, 1.0)
    grasped_place = hamacher(grasped, part1)
    lifted = ((tcp_to_obj < 0.02) & (c["grip"] > 0.0)
              & (c["obj"][:, 2] - 0.015 > c["obj0"][:, 2]))
    over_wall = c["obj"][:, 1] > 0.75
    reward = torch.where(
        lifted,
        torch.where(over_wall, grasped_place + 1.0 + 4.0 + 3.0 * part2,
                    grasped_place + 1.0 + 4.0 * part1),
        grasped_place)
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)
    return reward, grasped, part2, obj_to_target


def _law_pick_out_of_hole(c):  # case 29
    obj_to_target = norm(c["obj"] - c["goal"])
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    radius = _dist2(c["tcp"], c["obj0"])
    floor = _log_floor(radius, 0.03, 0.015, 0.15)
    above_floor = _above(c["tcp"][:, 2], floor, 0.02, clamp=True)
    grasped = caging(c, c["obj"], 0.015, 0.02, 0.01, 0.03, 0.1, True)
    in_place = longtail(obj_to_target, 0.0, 0.02, norm(c["obj0"] - c["goal"]))
    reward = hamacher(grasped, in_place)
    grasp_success = ((tcp_to_obj < 0.04) & (c["obj"][:, 2] - 0.02 > c["obj0"][:, 2])
                     & ~(c["grip"] < 0.33))
    reward = torch.where(grasp_success, reward + 1.0 + 5.0 * hamacher(in_place, above_floor),
                         reward)
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)
    return reward, grasped, in_place, obj_to_target


def _law_plate_slide(c, variant):  # cases 31-34
    obj_to_target = norm(c["obj"] - c["goal"])
    in_margin = norm(c["obj0"] - c["goal"])
    grasp_margin = norm(vec(_HAND_INIT, c["obj0"]) - c["obj0"])
    if variant != "forward":
        in_margin = in_margin - 0.05
        grasp_margin = grasp_margin - 0.05
    in_place = longtail(obj_to_target, 0.0, 0.05, in_margin)
    tcp_to_obj = norm(c["tcp"] - c["obj"])
    grasped = longtail(tcp_to_obj, 0.0, 0.05, grasp_margin)
    if variant == "forward":
        reward = 8.0 * hamacher(grasped, in_place)
    else:
        reward = torch.where((c["tcp"][:, 2] <= 0.03) & (tcp_to_obj < 0.07),
                             2.0 + 7.0 * in_place, 1.5 * grasped)
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)
    return reward, grasped, in_place, obj_to_target


def _law_peg_unplug_side(c):  # case 36
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    obj_to_target = norm(c["obj"] - c["goal"])
    grasped = caging(c, c["obj"], 0.025, 0.05, 0.01, 0.005, 0.8, True)
    in_place = longtail(obj_to_target, 0.0, 0.05, norm(c["obj0"] - c["goal"]))
    grasp_success = (c["grip"] > 0.5) & (c["obj"][:, 0] - c["obj0"][:, 0] > 0.015)
    reward = torch.where(grasp_success & (tcp_to_obj < 0.035),
                         1.0 + 2.0 * grasped + 5.0 * in_place, 2.0 * grasped)
    reward = torch.where(obj_to_target <= 0.05, 10.0, reward)
    return reward, grasped, in_place, obj_to_target


def _law_soccer(c):  # case 37
    scaled_to_target = _dscaled(c["obj"], c["goal"], (3.0, 1.0, 1.0))
    scaled_init = _dscaled(c["obj"], c["obj0"], (3.0, 1.0, 1.0))
    in_place = longtail(scaled_to_target, 0.0, 0.07, scaled_init)
    goal_line = c["goal"][:, 1] - 0.1
    past_line = ((c["obj"][:, 1] > goal_line)
                 & (torch.abs(c["obj"][:, 0] - c["goal"][:, 0]) > 0.10))
    in_place = torch.where(
        past_line,
        torch.clamp(in_place - 2.0 * ((c["obj"][:, 1] - goal_line) / (1.0 - goal_line)),
                    0.0, 1.0),
        in_place)
    grasped = _sweep_caging(c, c["obj"], 0.013, 0.01, 0.005)
    reward = 3.0 * grasped + 6.5 * in_place
    reward = torch.where(scaled_to_target < 0.07, 10.0, reward)
    return reward, grasped, in_place, norm(c["obj"] - c["goal"])


def _law_push_wall(c):  # case 41
    obj = c["obj"]
    midpoint = torch.stack([torch.full_like(obj[:, 2], -0.05),
                            torch.full_like(obj[:, 2], 0.77), obj[:, 2]], 1)
    tcp_to_obj = norm(obj - c["tcp"])
    mid = _dscaled(obj, midpoint, (3.0, 1.0, 1.0))
    mid_init = _dscaled(c["obj0"], midpoint, (3.0, 1.0, 1.0))
    part1 = longtail(mid, 0.0, 0.05, mid_init)
    target_to_obj = norm(obj - c["goal"])
    part2 = longtail(target_to_obj, 0.0, 0.05, norm(c["obj0"] - c["goal"]))
    grasped = caging(c, obj, 0.015, 0.05, 0.01, 0.005, 1.0, True)
    touch = (tcp_to_obj < 0.02) & (c["grip"] > 0.0)
    over_wall = obj[:, 1] > 0.75
    reward = torch.where(
        touch,
        torch.where(over_wall, 2.0 * grasped + 1.0 + 4.0 + 3.0 * part2,
                    2.0 * grasped + 1.0 + 4.0 * part1),
        2.0 * grasped)
    reward = torch.where(target_to_obj < 0.05, 10.0, reward)
    return reward, grasped, part2, target_to_obj


def _law_push_back(c):  # case 42
    tcp_to_obj = norm(c["obj"] - c["tcp"])
    target_to_obj = norm(c["obj"] - c["goal"])
    init = norm(c["obj0"] - c["goal"])
    in_place = longtail(target_to_obj, 0.0, 0.05, init)
    grasped = _sweep_caging(c, c["obj"], 0.007, 0.003, 0.01)
    reward = hamacher(grasped, in_place)
    moving = ((tcp_to_obj < 0.01) & (c["grip"] > 0.0) & (c["grip"] < 0.55)
              & (init - target_to_obj > 0.01))
    reward = torch.where(moving, reward + 1.0 + 5.0 * in_place, reward)
    reward = torch.where(target_to_obj < 0.05, 10.0, reward)
    return reward, grasped, in_place, target_to_obj


def _law_shelf_place(c):  # case 45
    obj, goal = c["obj"], c["goal"]
    obj_to_target = norm(obj - goal)
    tcp_to_obj = norm(obj - c["tcp"])
    in_place = longtail(obj_to_target, 0.0, 0.05, norm(c["obj0"] - goal))
    grasped = caging(c, obj, 0.02, 0.05, 0.01, 0.01, 1.0)
    reward = hamacher(grasped, in_place)
    in_band = ((obj[:, 2] > 0.0) & (obj[:, 2] < 0.24)
               & (obj[:, 0] > goal[:, 0] - 0.15) & (obj[:, 0] < goal[:, 0] + 0.15))
    under_shelf = in_band & (obj[:, 1] > goal[:, 1] - 0.15) & (obj[:, 1] < goal[:, 1])
    z_scaling = (0.24 - obj[:, 2]) * inv(0.24)
    y_scaling = (obj[:, 1] - (goal[:, 1] - 0.15)) * inv(0.15)
    bound_loss = hamacher(y_scaling, z_scaling)
    in_place = torch.where(under_shelf, torch.clamp(in_place - bound_loss, 0.0, 1.0), in_place)
    in_place = torch.where(in_band & (obj[:, 1] > goal[:, 1]), 0.0, in_place)
    lifted = ((tcp_to_obj < 0.025) & (c["grip"] > 0.0)
              & (obj[:, 2] - 0.01 > c["obj0"][:, 2]))
    reward = torch.where(lifted, reward + 1.0 + 5.0 * in_place, reward)
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)
    return reward, grasped, in_place, obj_to_target


def _law_sweep(c, into=False):  # cases 46/47
    target = set_col(c["goal"], 2, c["obj"][:, 2]) if into else c["goal"]
    obj_to_target = norm(c["obj"] - target)
    in_place = longtail(obj_to_target, 0.0, 0.05, norm(c["obj0"] - target))
    grasped = _sweep_caging(c, c["obj"], 0.02, 0.005 if into else 0.01,
                            0.01 if into else 0.005)
    reward = 2.0 * grasped + 6.0 * hamacher(grasped, in_place)
    reward = torch.where(obj_to_target < 0.05, 10.0, reward)
    return reward, grasped, in_place, obj_to_target


def _law_hammer(c):  # case 22
    hand = c["tcp"]
    hammer = c["obj"]
    hammer_head = hammer + vec((0.16, 0.06, 0.0), hammer)
    threshed = set_col(hammer, 0, torch.where(torch.abs(hammer[:, 0] - hand[:, 0]) < 0.07,
                                              hand[:, 0], hammer[:, 0]))
    reward_quat = _quat_reward(c["quat"], (1.0, 0.0, 0.0, 0.0), 0.4)
    reward_grab = caging(c, threshed, 0.015, 0.02, 0.01, 0.01, 1.0, True, False)
    in_place = (0.1 * _f(hammer_head[:, 2] > 0.02)
                + 0.9 * longtail(norm(hammer_head - c["goal"]), 0.0, 0.02, 0.2))
    reward = (2.0 * reward_grab + 6.0 * in_place) * reward_quat
    # Surrogate nail joint: the second body's displacement from its spawn.
    success = norm(c["obj2"] - c["obj2_0"]) > 0.09
    reward = torch.where(success & (reward > 5.0), 10.0, reward)
    return reward, reward_grab, in_place, torch.zeros_like(reward)


def _law_stick_push(c):  # case 38
    stick = c["obj"] + vec((0.015, 0.0, 0.0), c["obj"])
    container = c["obj2"]
    tcp_to_stick = norm(stick - c["tcp"])
    stick_to_target = norm(stick - c["goal"])
    stick_in_place = longtail(stick_to_target, 0.0, 0.12, norm(c["obj0"] - c["goal"]) - 0.12)
    container_to_target = norm(container - c["goal"])
    container_in_place = longtail(container_to_target, 0.0, 0.12,
                                  norm(c["obj2_0"] - c["goal"]) - 0.12)
    # StickCagingReward(.., 0.04, 0.05, 0.01, 0.01, high, use_stick_init)
    grasped = caging(c, stick, 0.04, 0.05, 0.01, 0.01, 1.0, True, False, init_obj=c["obj0"])
    grasp_success = ((tcp_to_stick < 0.02) & (c["grip"] > 0.0)
                     & (stick[:, 2] - 0.01 > c["obj0"][:, 2]))
    grasped = torch.where(grasp_success, 1.0, grasped)
    reward = torch.where(
        grasp_success,
        torch.where(container_to_target <= 0.12, 10.0,
                    2.0 + 5.0 * stick_in_place + 3.0 * container_in_place),
        grasped)
    return reward, grasped, stick_in_place, container_to_target


def _law_stick_pull(c):  # case 39
    stick = c["obj"]
    handle = c["obj2"]
    end_of_stick = stick + vec((0.12, 0.0, 0.0), stick)
    container = handle + vec((0.05, 0.0, 0.0), handle)
    container_init = c["obj2_0"] + vec((0.05, 0.0, 0.0), handle)
    tcp_to_stick = norm(stick - c["tcp"])
    handle_to_target = norm(handle - c["goal"])
    stick_to_container = _dscaled(stick, container, (1.0, 1.0, 2.0))
    stick_in_place = longtail(stick_to_container, 0.0, 0.05,
                              _dscaled(c["obj0"], container_init, (1.0, 1.0, 2.0)))
    stick_to_target = norm(stick - c["goal"])
    stick_in_place2 = longtail(stick_to_target, 0.0, 0.05, norm(c["obj0"] - c["goal"]))
    container_to_target = norm(container - c["goal"])
    container_in_place = longtail(container_to_target, 0.0, 0.05,
                                  norm(c["obj2_0"] - c["goal"]))
    grasped = caging(c, stick, 0.014, 0.05, 0.01, 0.01, 1.0, True, False,
                     init_obj=c["obj2_0"])
    grasp_success = ((tcp_to_stick < 0.02) & (c["grip"] > 0.0)
                     & (stick[:, 2] - 0.01 > c["obj0"][:, 2]))
    grasped = torch.where(grasp_success, 1.0, grasped)
    grasped_place = hamacher(grasped, stick_in_place)
    inserted = ((end_of_stick[:, 0] >= handle[:, 0])
                & (torch.abs(end_of_stick[:, 1] - handle[:, 1]) <= 0.040)
                & (torch.abs(end_of_stick[:, 2] - handle[:, 2]) <= 0.060))
    reward = torch.where(
        grasp_success,
        torch.where(
            inserted,
            torch.where(handle_to_target <= 0.12, 10.0,
                        1.0 + grasped_place + 5.0 + 2.0 * stick_in_place2
                        + container_in_place),
            1.0 + grasped_place + 5.0 * stick_in_place),
        grasped_place)
    return reward, grasped, stick_in_place, handle_to_target


# name -> law(ctx): every task whose published law is computable from the
# surrogate's state.
LAWS = {
    "assembly-v3": lambda c: _law_assembly(c, False),
    "basketball-v3": _law_basketball,
    "bin-picking-v3": _law_bin_picking,
    "box-close-v3": _law_box_close,
    "button-press-topdown-wall-v3": _law_button_topdown_wall,
    "button-press-wall-v3": _law_button_wall,
    "coffee-pull-v3": _law_coffee_push_pull,
    "coffee-push-v3": _law_coffee_push_pull,
    "dial-turn-v3": _law_dial_turn,
    "disassemble-v3": lambda c: _law_assembly(c, True),
    "door-close-v3": _law_door_close,
    "door-lock-v3": _law_door_lock,
    "door-open-v3": _law_door_open,
    "door-unlock-v3": _law_door_unlock,
    "hand-insert-v3": _law_hand_insert,
    "handle-pull-side-v3": lambda c: _law_handle_pull(c, True),
    "handle-pull-v3": lambda c: _law_handle_pull(c, False),
    "lever-pull-v3": _law_lever_pull,
    "pick-place-wall-v3": _law_pick_place_wall,
    "pick-out-of-hole-v3": _law_pick_out_of_hole,
    "plate-slide-v3": lambda c: _law_plate_slide(c, "forward"),
    "plate-slide-side-v3": lambda c: _law_plate_slide(c, "side"),
    "plate-slide-back-v3": lambda c: _law_plate_slide(c, "back"),
    "plate-slide-back-side-v3": lambda c: _law_plate_slide(c, "backside"),
    "peg-unplug-side-v3": _law_peg_unplug_side,
    "soccer-v3": _law_soccer,
    "push-wall-v3": _law_push_wall,
    "push-back-v3": _law_push_back,
    "shelf-place-v3": _law_shelf_place,
    "sweep-into-v3": lambda c: _law_sweep(c, True),
    "sweep-v3": lambda c: _law_sweep(c, False),
    "hammer-v3": _law_hammer,
    "stick-push-v3": _law_stick_push,
    "stick-pull-v3": _law_stick_pull,
}

# Tasks whose obs' second slot carries a second body (nail / container),
# with its surrogate spawn point (None: at the sampled goal).
TWO_BODY = {
    "hammer-v3": None,
    "stick-push-v3": (0.2, 0.6, 0.02),
    "stick-pull-v3": (0.2, 0.6, 0.02),
}

# Rest quaternion per task for the obs and the quat-error terms.
REST_QUAT = {
    "assembly-v3": (0.7071068, 0.0, 0.0, 0.7071068),
    "disassemble-v3": (0.7071068, 0.0, 0.0, 0.7071068),
    "box-close-v3": (0.7071068, 0.0, 0.0, 0.7071068),
    # The stick's obs quats are XYZW; identity in that order is (0, 0, 0, 1).
    "stick-push-v3": (0.0, 0.0, 0.0, 1.0),
    "stick-pull-v3": (0.0, 0.0, 0.0, 1.0),
}
