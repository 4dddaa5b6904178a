"""Shadow Dexterous Hand family: HandReach and HandManipulate{Block,Egg,Pen},
batched in PyTorch.

Counterpart of ``envpool_tpu/envs/robotics/hand.py`` (reference:
``envpool/mujoco/robotics/hand.h``, gymnasium_robotics
``envs/shadow_dexterous_hand/{reach,manipulate}.py``): 24 hinge joints, 20
position actuators (the four distal joints copy their PIP neighbour's
target), dt = 0.04 s, a rate-limited servo toward ``center + a * range``.

HandReach's fingertips are the forward kinematics of the Shadow Hand model
(``physics/dynamics.py::site_positions`` on the committed
``physics/assets/gr_hand_reach.npz``); its goal picks the thumb and one
of the four fingers (the JAX env's ``lax.switch``) as one gathered update
of all five rows.  HandManipulate's object follows the JAX env's
surrogate (a fixed finger-to-object twist coupling ``W``, the object
anchored to the palm); it loads no model.  The trigonometric functions of
the rotations and goal distances run in float64 and round once to float32,
so the card and the CPU give the same bits.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ...core.env import EnvOut, TorchEnv
from ...core.rng import Draws
from ...core.specs import ArraySpec
from ...ops.batched import acos, atan2, const, cos, f32, inv, norm, sin, tanh
from ...physics.dynamics import site_positions
from ...physics.model import load_model

__all__ = [
    "HandManipulateEnv",
    "HandReachEnv",
    "euler2quat",
    "quat2euler",
    "quat_conj",
    "quat_from_angle_axis",
    "quat_mul",
]

_DT = 0.04
_SERVO_GAIN = 0.25
_SERVO_CAP = 0.35

# 20 actuators -> 24 joints (order WRJ1..THJ0); the four distal J0 joints
# (FF/MF/RF/LF) are tendon-coupled to their J1 neighbour.
ACT_TO_JOINT = np.asarray(
    [0, 1, 2, 3, 4, 6, 7, 8, 10, 11, 12, 14, 15, 16, 17, 19, 20, 21, 22, 23]
)
COUPLED = np.asarray([(5, 4), (9, 8), (13, 12), (18, 17)])  # (J0, J1)

FINGERTIP_SITES = (
    "robot0:S_fftip",
    "robot0:S_mftip",
    "robot0:S_rftip",
    "robot0:S_lftip",
    "robot0:S_thtip",
)

# HandReach constants measured from the oracle (reach.py _env_setup).
PALM_XPOS = np.asarray([1.00558936, 0.96046261, 0.13999892], np.float32)
REACH_INIT_QPOS = np.asarray(
    [-0.1651, -0.3197, 0.1434, 0.3203, 0.7126, 0.6705, 0.0002, 0.3153,
     0.766, 0.7323, 0.0004, 0.3674, 0.712, 0.6699, 0.0525, -0.1362,
     0.3987, 0.7416, 0.7041, 0.0037, 0.5506, -0.0145, -0.0015, -0.7895],
    np.float32,
)
# Base (pre-randomization) object pose per manipulate model.
OBJ_INIT = {
    "hand/manipulate_block.xml": (1.005, 0.869, 0.1715),
    "hand/manipulate_egg.xml": (1.005, 0.87, 0.17),
    "hand/manipulate_pen.xml": (1.0056, 0.8752, 0.1466),
}
TARGET_POS_RANGE = np.asarray(
    [[-0.04, 0.04], [-0.06, 0.02], [0.0, 0.06]], np.float32
)

# Shadow Hand joint ranges.
JNT_LO = np.asarray(
    [-0.489, -0.698, -0.349, 0.0, 0.0, 0.0, -0.349, 0.0, 0.0, 0.0,
     -0.349, 0.0, 0.0, 0.0, 0.0, -0.349, 0.0, 0.0, 0.0, -1.047,
     0.0, -0.209, -0.524, -1.571],
    np.float32,
)
JNT_HI = np.asarray(
    [0.14, 0.489, 0.349, 1.571, 1.571, 1.571, 0.349, 1.571, 1.571,
     1.571, 0.349, 1.571, 1.571, 1.571, 0.785, 0.349, 1.571, 1.571,
     1.571, 1.047, 1.222, 0.209, 0.524, 0.0],
    np.float32,
)


# -- quaternion helpers (wxyz, gymnasium_robotics.utils.rotations) -----------


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * const((1.0, -1.0, -1.0, -1.0), q.device)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """``[..., 4]`` from angles ``[...]`` and axes ``[..., 3]`` (normalised
    here)."""
    axis = axis / (norm(axis) + f32(1e-12))[..., None]
    half = angle * 0.5
    return torch.cat([cos(half)[..., None], sin(half)[..., None] * axis], -1)


def _quat2mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    n = (q * q).sum(-1)
    s = 2.0 / torch.clamp_min(n, f32(1e-12))
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z
    return torch.stack(
        [
            torch.stack([1.0 - (yY + zZ), xY - wZ, xZ + wY], -1),
            torch.stack([xY + wZ, 1.0 - (xX + zZ), yZ - wX], -1),
            torch.stack([xZ - wY, yZ + wX, 1.0 - (xX + yY)], -1),
        ],
        -2,
    )


def quat2euler(q: torch.Tensor) -> torch.Tensor:
    """rotations.quat2euler: mat2euler(quat2mat(q)) with its sign and axis
    conventions."""
    m = _quat2mat(q)
    cy = torch.sqrt(m[..., 2, 2] ** 2 + m[..., 1, 2] ** 2)
    cond = cy > f32(1e-6)
    e2 = torch.where(cond, -atan2(m[..., 0, 1], m[..., 0, 0]),
                     -atan2(-m[..., 1, 0], m[..., 1, 1]))
    e1 = -atan2(-m[..., 0, 2], cy)
    e0 = torch.where(cond, -atan2(m[..., 1, 2], m[..., 2, 2]), 0.0)
    return torch.stack([e0, e1, e2], -1)


def euler2quat(e: torch.Tensor) -> torch.Tensor:
    """rotations.euler2quat."""
    ai, aj, ak = e[..., 2] * 0.5, -e[..., 1] * 0.5, e[..., 0] * 0.5
    si, sj, sk = sin(ai), sin(aj), sin(ak)
    ci, cj, ck = cos(ai), cos(aj), cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    return torch.stack(
        [cj * cc + sj * ss, cj * cs - sj * sc, -(cj * ss + sj * cc), cj * sc - sj * cs], -1
    )


def _parallel_quats() -> np.ndarray:
    """The 24 cube-symmetry quaternions (rotations.get_parallel_rotations),
    the JAX package's numpy construction."""

    def euler2mat_np(e):
        r, p, y = e
        Rx = np.array(
            [[1, 0, 0], [0, np.cos(r), -np.sin(r)], [0, np.sin(r), np.cos(r)]]
        )
        Ry = np.array(
            [[np.cos(p), 0, np.sin(p)], [0, 1, 0], [-np.sin(p), 0, np.cos(p)]]
        )
        Rz = np.array(
            [[np.cos(y), -np.sin(y), 0], [np.sin(y), np.cos(y), 0], [0, 0, 1]]
        )
        return Rz @ Ry @ Rx

    def mat2euler_np(m):
        sy = np.sqrt(m[0, 0] ** 2 + m[1, 0] ** 2)
        if sy > 1e-6:
            return np.array(
                [np.arctan2(m[2, 1], m[2, 2]), np.arctan2(-m[2, 0], sy),
                 np.arctan2(m[1, 0], m[0, 0])]
            )
        return np.array(
            [np.arctan2(-m[1, 2], m[1, 1]), np.arctan2(-m[2, 0], sy), 0.0]
        )

    mult90 = [0, np.pi / 2, -np.pi / 2, np.pi]
    out = []
    for euler in itertools.product(mult90, repeat=3):
        canonical = mat2euler_np(euler2mat_np(euler))
        canonical = np.round(canonical / (np.pi / 2))
        if canonical[0] == -2:
            canonical[0] = 2
        if canonical[2] == -2:
            canonical[2] = 2
        canonical *= np.pi / 2
        if all((canonical != rot).any() for rot in out):
            out.append(canonical)
    quats = []
    for e in out:
        r, p, y = e / 2
        quats.append(
            [
                np.cos(r) * np.cos(p) * np.cos(y)
                + np.sin(r) * np.sin(p) * np.sin(y),
                np.sin(r) * np.cos(p) * np.cos(y)
                - np.cos(r) * np.sin(p) * np.sin(y),
                np.cos(r) * np.sin(p) * np.cos(y)
                + np.sin(r) * np.cos(p) * np.sin(y),
                np.cos(r) * np.cos(p) * np.sin(y)
                - np.sin(r) * np.sin(p) * np.cos(y),
            ]
        )
    return np.asarray(quats, np.float32)


PARALLEL_QUATS = _parallel_quats()


def _rows(value: torch.Tensor, n: int) -> torch.Tensor:
    """A constant ``value`` broadcast to ``n`` rows (a new tensor)."""
    return value.expand(n, *value.shape).clone()


class _HandBase(TorchEnv):
    """The shared 24-joint servo bank."""

    def __init__(self, config):
        super().__init__(config)
        a2j = ACT_TO_JOINT
        self.act_lo, self.act_hi = JNT_LO[a2j], JNT_HI[a2j]
        dev = self.device
        self._center = torch.as_tensor((self.act_lo + self.act_hi) / 2, device=dev)
        self._range = torch.as_tensor((self.act_hi - self.act_lo) / 2, device=dev)
        self._act_lo = torch.as_tensor(self.act_lo, device=dev)
        self._act_hi = torch.as_tensor(self.act_hi, device=dev)
        self._jnt_lo = torch.as_tensor(JNT_LO, device=dev)
        self._jnt_hi = torch.as_tensor(JNT_HI, device=dev)
        # Each joint's actuator, the coupled distal joints their PIP's.
        src = np.zeros(24, np.int64)
        src[ACT_TO_JOINT] = np.arange(20)
        src[COUPLED[:, 0]] = src[COUPLED[:, 1]]
        self._joint_act = torch.as_tensor(src, device=dev)

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (20,), -1.0, 1.0)}

    def servo_step(self, qpos, action):
        """One 0.04 s control step of the servo bank: ``(qpos, qvel)``."""
        a = torch.clamp(action.reshape(-1, 20).to(torch.float32), -1.0, 1.0)
        target20 = torch.minimum(torch.maximum(self._center + a * self._range, self._act_lo),
                                 self._act_hi)
        target = target20[:, self._joint_act]
        delta = torch.clamp(_SERVO_GAIN * (target - qpos), -_SERVO_CAP, _SERVO_CAP)
        new_qpos = torch.minimum(torch.maximum(qpos + delta, self._jnt_lo), self._jnt_hi)
        return new_qpos, (new_qpos - qpos) * inv(_DT)


class HandReachEnv(_HandBase):
    """HandReach: the fingertips to target positions."""

    DEFAULT_CONFIG = {
        "reward_threshold": 0.0,
        "xml_file": "hand/reach.xml",
        "reward_type": "sparse",
        "distance_threshold": 0.01,
    }

    def __init__(self, config):
        super().__init__(config)
        self.sparse = str(config["reward_type"]) == "sparse"
        self.thr = float(config["distance_threshold"])
        self.model = load_model(str(config["xml_file"]))
        self._site_idx = [self.model.site_names.index(s) for s in FINGERTIP_SITES]
        # The FK of the initial pose, once, in float32 on the CPU.
        tips = self._fingertips(torch.as_tensor(REACH_INIT_QPOS)[None])
        self.initial_goal = tips.reshape(5, 3).numpy()
        dev = self.device
        self._goal0 = torch.as_tensor(self.initial_goal, device=dev)
        self._init_qpos = torch.as_tensor(REACH_INIT_QPOS, device=dev)
        meeting = PALM_XPOS + np.asarray([0.0, -0.09, 0.05], np.float32)
        self._meeting = torch.as_tensor(meeting, device=dev)
        self._fingers = torch.arange(5, device=dev)

    def _fingertips(self, qpos):
        """``[N, 15]``: the five fingertip sites' world positions."""
        sites = site_positions(self.model, qpos)
        return sites[:, self._site_idx].reshape(-1, 15)

    def state_spec(self):
        inf = float("inf")
        return {
            "obs:observation": ArraySpec(np.float32, (63,), -inf, inf),
            "obs:achieved_goal": ArraySpec(np.float32, (15,), -inf, inf),
            "obs:desired_goal": ArraySpec(np.float32, (15,), -inf, inf),
            "info:is_success": ArraySpec(np.float32, (), 0.0, 1.0),
            "info:distance": ArraySpec(np.float32, (), 0.0, inf),
        }

    def compute_reward(self, achieved, desired):
        d = norm(achieved - desired)
        if self.sparse:
            return -(d > self.thr).to(torch.float32)
        return -d

    # -- reset ----------------------------------------------------------------

    def plan_reset(self, d):
        """The reset's draws, in the JAX env's order (``sample_goal``)."""
        d.randint("finger", 0, 4)
        d.normal("meeting", (3,))
        d.uniform("keep_initial")

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    def sample_goal(self, draws):
        """reach.py _sample_goal: the thumb and one finger moved to 5 mm
        short of a noisy meeting point, or, with probability 0.1, the
        initial fingertips; ``[N, 15]``."""
        finger = draws["finger"].long()
        n = finger.shape[0]
        meeting = self._meeting + 0.005 * draws["meeting"]
        goal = self._goal0.expand(n, 5, 3)
        dvec = meeting[:, None] - goal
        dvec = dvec / (norm(dvec) + f32(1e-12))[..., None]
        moved = meeting[:, None] - 0.005 * dvec
        pick = (self._fingers == 4) | (self._fingers == finger[:, None])
        goal = torch.where(pick[..., None], moved, goal)
        goal = torch.where((draws["keep_initial"] < 0.1)[:, None, None], self._goal0, goal)
        return goal.reshape(n, 15)

    def _obs(self, st, tips):
        d = norm(tips - st["goal"])
        return {
            "obs:observation": torch.cat([st["qpos"], st["qvel"], tips], 1),
            "obs:achieved_goal": tips,
            "obs:desired_goal": st["goal"],
            "info:is_success": (d < self.thr).to(torch.float32),
            "info:distance": d,
        }

    def reset_env(self, draws):
        goal = self.sample_goal(draws)
        n = goal.shape[0]
        st = {
            "qpos": _rows(self._init_qpos, n),
            "qvel": goal.new_zeros(n, 24),
            "goal": goal,
        }
        # The fingertips of the initial pose: the initial goal.
        return st, self._obs(st, _rows(self._goal0.reshape(15), n))

    def step_env(self, state, action, draws):
        del draws
        qpos, qvel = self.servo_step(state["qpos"], action)
        st = {"qpos": qpos, "qvel": qvel, "goal": state["goal"]}
        tips = self._fingertips(qpos)
        return EnvOut(state=st, obs=self._obs(st, tips),
                      reward=self.compute_reward(tips, state["goal"]),
                      terminated=torch.zeros_like(qpos[:, 0], dtype=torch.bool))


class HandManipulateEnv(_HandBase):
    """HandManipulate{Block,Egg,Pen} (+TouchSensors) by config."""

    DEFAULT_CONFIG = {
        "reward_threshold": 0.0,
        "xml_file": "hand/manipulate_block.xml",
        "reward_type": "sparse",
        "target_position": "random",    # random | ignore | fixed
        "target_rotation": "xyz",       # xyz | z | parallel | ignore | fixed
        "distance_threshold": 0.01,
        "rotation_threshold": 0.1,
        "randomize_initial_position": True,
        "randomize_initial_rotation": True,
        "ignore_z_target_rotation": False,
        "touch_get_obs": "off",         # off | boolean | sensordata
        "n_touch": 92,
    }

    def __init__(self, config):
        super().__init__(config)
        self.sparse = str(config["reward_type"]) == "sparse"
        self.pos_mode = str(config["target_position"])
        self.rot_mode = str(config["target_rotation"])
        self.d_thr = float(config["distance_threshold"])
        self.r_thr = float(config["rotation_threshold"])
        self.ignore_z = bool(config["ignore_z_target_rotation"])
        self.touch = str(config["touch_get_obs"])
        self.n_touch = int(config["n_touch"])
        base_xml = str(config["xml_file"]).replace("_touch_sensors", "")
        self.obj_init = np.asarray(
            OBJ_INIT.get(base_xml, OBJ_INIT["hand/manipulate_block.xml"]), np.float32
        )
        self.obs_dim = 61 + (self.n_touch if self.touch != "off" else 0)
        # The fixed finger-to-object twist coupling (the JAX env's surrogate
        # dynamics): rows the object's angular velocity, columns the hand's
        # qvel.
        rng = np.random.default_rng(12345)
        W = np.zeros((3, 24), np.float32)
        W[0, [3, 4, 5, 7, 8, 9]] = 0.25      # curls -> roll
        W[1, [0, 1]] = (0.6, 0.4)            # wrist -> pitch
        W[1, [11, 12, 13]] = 0.2
        W[2, [2, 6, 10, 15, 19, 20]] = 0.3   # abduction + thumb -> yaw
        W += 0.02 * rng.standard_normal((3, 24)).astype(np.float32)
        self.W = W
        dev = self.device
        self._W = torch.as_tensor(W, device=dev)
        self._obj_init = torch.as_tensor(self.obj_init, device=dev)
        self._parallel = torch.as_tensor(PARALLEL_QUATS, device=dev)
        self._z_axis = const((0.0, 0.0, 1.0), dev)
        self._identity = const((1.0, 0.0, 0.0, 0.0), dev)

    # -- the oracle's pure functions --------------------------------------------

    def goal_distance(self, a, b):
        """manipulate.py _goal_distance (7-dim pose goals): ``(d_pos,
        d_rot)``."""
        d_pos = a.new_zeros(a.shape[:-1])
        d_rot = a.new_zeros(a.shape[:-1])
        if self.pos_mode != "ignore":
            d_pos = norm(a[..., :3] - b[..., :3])
        if self.rot_mode != "ignore":
            quat_a, quat_b = a[..., 3:], b[..., 3:]
            if self.ignore_z:
                ea, eb = quat2euler(quat_a), quat2euler(quat_b)
                ea = torch.cat([ea[..., :2], eb[..., 2:]], -1)
                quat_a = euler2quat(ea)
            quat_diff = quat_mul(quat_a, quat_conj(quat_b))
            d_rot = 2 * acos(torch.clamp(quat_diff[..., 0], -1.0, 1.0))
        return d_pos, d_rot

    def is_success(self, achieved, desired):
        d_pos, d_rot = self.goal_distance(achieved, desired)
        return (d_pos < self.d_thr).to(torch.float32) * (d_rot < self.r_thr).to(torch.float32)

    def compute_reward(self, achieved, desired):
        if self.sparse:
            return self.is_success(achieved, desired) - 1.0
        d_pos, d_rot = self.goal_distance(achieved, desired)
        return -(10.0 * d_pos + d_rot)

    # -- draws ----------------------------------------------------------------

    def _plan_rotation(self, d, prefix, mode):
        if mode in ("z", "parallel", "xyz", "ignore"):
            d.uniform(prefix + "angle", (), -np.pi, np.pi)
        if mode == "parallel":
            d.randint(prefix + "parallel", 0, len(PARALLEL_QUATS))
        elif mode in ("xyz", "ignore"):
            d.uniform(prefix + "axis", (3,), -1.0, 1.0)

    def plan_reset(self, d):
        """The reset's draws, in the JAX env's order: the initial rotation,
        the position noise, then the goal (``sample_goal``)."""
        if bool(self.config["randomize_initial_rotation"]):
            self._plan_rotation(d, "init_", self.rot_mode)
        if bool(self.config["randomize_initial_position"]) and self.pos_mode != "fixed":
            d.normal("pos_noise", (3,))
        if self.pos_mode == "random":
            d.uniform("goal_offset", (3,), TARGET_POS_RANGE[:, 0], TARGET_POS_RANGE[:, 1])
        if self.rot_mode in ("z", "parallel", "xyz"):
            self._plan_rotation(d, "goal_", self.rot_mode)

    def reset_draws(self, sub):
        d = Draws(sub)
        self.plan_reset(d)
        return d.out

    def _rotation(self, draws, prefix, mode):
        """The drawn rotation of ``mode`` (the identity where none)."""
        angle = draws[prefix + "angle"]
        if mode == "z":
            return quat_from_angle_axis(angle, self._z_axis.expand(angle.shape[0], 3))
        if mode == "parallel":
            zq = quat_from_angle_axis(angle, self._z_axis.expand(angle.shape[0], 3))
            return quat_mul(zq, self._parallel[draws[prefix + "parallel"].long()])
        return quat_from_angle_axis(angle, draws[prefix + "axis"])

    def sample_goal(self, draws, obj_pos):
        """manipulate.py _sample_goal: ``[N, 7]``."""
        n = obj_pos.shape[0]
        target_pos = obj_pos + draws["goal_offset"] if self.pos_mode == "random" else obj_pos
        if self.rot_mode in ("z", "parallel", "xyz"):
            quat = self._rotation(draws, "goal_", self.rot_mode)
        else:
            quat = _rows(self._identity, n)
        quat = quat / norm(quat)[:, None]
        return torch.cat([target_pos, quat], 1)

    # -- specs and dynamics ---------------------------------------------------

    def state_spec(self):
        inf = float("inf")
        return {
            "obs:observation": ArraySpec(np.float32, (self.obs_dim,), -inf, inf),
            "obs:achieved_goal": ArraySpec(np.float32, (7,), -inf, inf),
            "obs:desired_goal": ArraySpec(np.float32, (7,), -inf, inf),
            "info:is_success": ArraySpec(np.float32, (), 0.0, 1.0),
            "info:d_pos": ArraySpec(np.float32, (), 0.0, inf),
            "info:d_rot": ArraySpec(np.float32, (), 0.0, inf),
        }

    def _touch_obs(self, qpos, held):
        """Surrogate touch: segments report contact while flexed and held."""
        curl = torch.clamp(qpos[:, 3:24], 0.0, 1.571) * inv(1.571)
        base = curl.repeat(1, 5)[:, : self.n_touch]
        val = base * held.to(torch.float32)[:, None]
        if self.touch == "boolean":
            return (val > 0.3).to(torch.float32)
        return val * 5.0  # sensordata scale

    def _obs(self, st):
        achieved = torch.cat([st["obj_pos"], st["obj_quat"]], 1)
        parts = [st["qpos"], st["qvel"], st["obj_vel"], achieved]
        if self.touch != "off":
            parts.insert(3, self._touch_obs(st["qpos"], st["held"]))
        d_pos, d_rot = self.goal_distance(achieved, st["goal"])
        success = ((d_pos < self.d_thr).to(torch.float32)
                   * (d_rot < self.r_thr).to(torch.float32))
        return {
            "obs:observation": torch.cat(parts, 1),
            "obs:achieved_goal": achieved,
            "obs:desired_goal": st["goal"],
            "info:is_success": success,
            "info:d_pos": d_pos,
            "info:d_rot": d_rot,
        }

    def reset_env(self, draws):
        n = draws["rows"].shape[0]
        quat = _rows(self._identity, n)
        if bool(self.config["randomize_initial_rotation"]):
            mode = self.rot_mode
            if mode in ("z", "parallel", "xyz", "ignore"):
                quat = quat_mul(quat, self._rotation(draws, "init_", mode))
        pos = _rows(self._obj_init, n)
        if bool(self.config["randomize_initial_position"]) and self.pos_mode != "fixed":
            pos = pos + 0.005 * draws["pos_noise"]
        quat = quat / norm(quat)[:, None]
        zeros = pos.new_zeros(n, 24)
        st = {
            "qpos": zeros,
            "qvel": zeros.clone(),
            "obj_pos": pos,
            "obj_quat": quat,
            "obj_vel": pos.new_zeros(n, 6),
            "held": torch.ones(n, dtype=torch.bool, device=pos.device),
            "goal": self.sample_goal(draws, pos),
        }
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        del draws
        qpos, qvel = self.servo_step(state["qpos"], action)
        # Surrogate object dynamics: the twist coupling of the joints'
        # velocities.
        omega = (qvel @ self._W.T) * _DT
        angle = norm(omega) + f32(1e-12)
        dq = quat_from_angle_axis(angle, omega / angle[:, None])
        quat = quat_mul(dq, state["obj_quat"])
        quat = quat / norm(quat)[:, None]
        # The mean curl of four fingers holds the object.
        curl = qpos[:, [3, 4, 7, 8, 11, 12]].mean(1)
        held = state["held"] & (curl > -0.2)
        # Anchored to the palm with a small drift; falls when released.
        drift = 0.002 * tanh(qvel @ self._W[0])
        pos = state["obj_pos"]
        pos = torch.stack([pos[:, 0] + torch.where(held, drift, 0.0), pos[:, 1],
                           pos[:, 2] + torch.where(held, 0.0, -0.05)], 1)
        obj_vel = torch.cat([(pos - state["obj_pos"]) * inv(_DT), omega * inv(_DT)], 1)
        st = {
            "qpos": qpos,
            "qvel": qvel,
            "obj_pos": pos,
            "obj_quat": quat,
            "obj_vel": obj_vel,
            "held": held,
            "goal": state["goal"],
        }
        achieved = torch.cat([pos, quat], 1)
        return EnvOut(state=st, obs=self._obs(st),
                      reward=self.compute_reward(achieved, state["goal"]),
                      terminated=torch.zeros_like(held))
