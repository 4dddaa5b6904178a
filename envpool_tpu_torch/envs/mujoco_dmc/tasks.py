"""dm_control suite tasks, batched: cheetah, pendulum, cartpole, walker,
hopper, reacher, acrobot, point_mass and swimmer.

Counterpart of ``envpool_tpu/envs/mujoco_dmc/tasks.py`` (its rewards and
observations, written for ``[N, ...]`` tensors).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...core import rng
from ...physics import dynamics
from ...physics.dynamics import site_positions
from ...physics.kinematics import _mv, model_tensors
from ...physics.model import load_constants
from . import rewards
from .base import DmcEnv

_COSINE_BOUND = float(np.cos(np.deg2rad(8)))  # pendulum.py


def _quadratic_control(action):
    """``[N, nu]``: dm_control's small-control term of each action."""
    return rewards.tolerance(action, margin=1, value_at_margin=0, sigmoid="quadratic")


class CheetahEnv(DmcEnv):
    """cheetah:run.

    dm_control settles each episode's start for 200 physics steps from
    random joints.  As in the JAX env, a bank of ``BANK`` settled states is
    made once and every reset draws one of them uniformly.  The JAX env
    draws its bank's joints from its own threefry key; the port's bank is
    its own: the joints of :meth:`start_states` settled by :meth:`settle`
    in float64 on the CPU, written beside the model by
    ``tools/export_models.py`` (``load_constants``), so that every device
    resets from the same states.  :meth:`install_bank` installs another
    bank (e.g. the JAX env's).
    """

    DOMAIN = "cheetah"
    _RUN_SPEED = 10.0
    BANK = 256
    BANK_SEED = 0xC0FFEE
    SETTLE_STEPS = 200

    def start_states(self) -> torch.Tensor:
        """``[BANK, nq]``: the bank's random joints at rest, drawn from the
        port's streams of seeds ``BANK_SEED + i`` (``core/rng.py``)."""
        keys = rng.seed_keys(self.BANK_SEED + np.arange(self.BANK), self.device)
        return self.joint_qpos(self.randomize_joints(rng.split(keys)[1]))

    def settle(self, qpos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``SETTLE_STEPS`` physics steps at zero control from ``qpos``
        ``[B, nq]`` at rest: the settled ``(qpos, qvel)``."""
        zeros = qpos.new_zeros(qpos.shape[0], self.model.nv)
        ctrl = qpos.new_zeros(qpos.shape[0], self.model.nu)
        return dynamics.step(self.model, qpos, zeros, ctrl, self.substeps,
                             self.contact, self.SETTLE_STEPS)

    @functools.cached_property
    def bank(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(qpos [BANK, nq], qvel [BANK, nv])`` the resets draw from: the
        committed bank, read at the first reset."""
        c = load_constants(self.model_name())
        return tuple(torch.as_tensor(c[k], dtype=torch.float32, device=self.device)
                     for k in ("bank_qpos", "bank_qvel"))

    def install_bank(self, qpos: torch.Tensor, qvel: torch.Tensor) -> None:
        """Reset from these ``[BANK, nq]`` and ``[BANK, nv]`` states."""
        self.bank = (qpos.to(self.device, torch.float32), qvel.to(self.device, torch.float32))

    def reset_draws(self, sub):
        """``index`` ``[N]`` uniform in ``[0, BANK)``."""
        return {"index": rng.randint(sub, 0, self.BANK)}

    def init_state(self, draws):
        bank_q, bank_v = self.bank
        idx = draws["index"].to(torch.int64)
        return bank_q[idx], bank_v[idx], {}

    def observe_dmc(self, qpos, qvel, extras):
        return {"position": qpos[:, 1:], "velocity": qvel}

    def reward_dmc(self, qpos, qvel, action, extras):
        return rewards.tolerance(
            self.subtree_linvel_x(qpos, qvel),
            bounds=(self._RUN_SPEED, float("inf")),
            margin=self._RUN_SPEED,
            value_at_margin=0,
            sigmoid="linear",
        )


class PendulumEnv(DmcEnv):
    """pendulum:swingup."""

    DOMAIN = "pendulum"

    def reset_draws(self, sub):
        """``angle`` ``[N]`` uniform in ``[-pi, pi)``."""
        return {"angle": rng.uniform_range(sub, -math.pi, math.pi, 1)[:, 0]}

    def init_state(self, draws):
        angle = draws["angle"]
        qpos = self._qpos0.expand(angle.shape[0], -1).clone()
        qpos[:, 0] = angle
        return qpos, qpos.new_zeros(qpos.shape[0], self.model.nv), {}

    def _pole_zz_xz(self, qpos):
        R = self.xmat(qpos)[:, self.body_index("pole")]
        return R[:, 2, 2], R[:, 0, 2]

    def observe_dmc(self, qpos, qvel, extras):
        zz, xz = self._pole_zz_xz(qpos)
        return {"orientation": torch.stack([zz, xz], 1), "velocity": qvel}

    def reward_dmc(self, qpos, qvel, action, extras):
        return rewards.tolerance(self._pole_zz_xz(qpos)[0], (_COSINE_BOUND, 1))


class CartpoleEnv(DmcEnv):
    """cartpole:{balance,balance_sparse,swingup,swingup_sparse,two_poles,
    three_poles}; the n-pole tasks run dm_control's procedural model
    (``cartpole._make_model(n)``) and the swing-up (non-sparse) task."""

    DOMAIN = "cartpole"
    _CART_RANGE = (-0.25, 0.25)
    _ANGLE_COSINE_RANGE = (0.995, 1)
    DEFAULT_CONFIG = dict(DmcEnv.DEFAULT_CONFIG, n_poles=1)

    def model_name(self):
        n = int(self.config["n_poles"])
        return super().model_name() + (f"_{n}" if n > 1 else "")

    @property
    def _swing_up(self) -> bool:
        return self.task.startswith("swingup") or self.task.endswith("poles")

    @property
    def _sparse(self) -> bool:
        return self.task.endswith("sparse")

    def reset_draws(self, sub):
        """``qpos`` ``[N, nq]``: standard normal for a swing-up, else the
        cart uniform in ``[-0.1, 0.1)`` and the poles in ``[-0.034,
        0.034)``; ``qvel`` ``[N, nv]`` standard normal."""
        nq, nv = self.model.nq, self.model.nv
        if self._swing_up:
            qpos = rng.normal(sub, 0, nq)
        else:
            qpos = torch.cat([rng.uniform_range(sub, -0.1, 0.1, 1),
                              rng.uniform_range(sub, -0.034, 0.034, nq - 1, slot=1)], 1)
        return {"qpos": qpos, "qvel": rng.normal(sub, 2 * nq, nv)}

    def init_state(self, draws):
        z = draws["qpos"]
        if self._swing_up:
            qpos = torch.cat([0.01 * z[:, :1], math.pi + 0.01 * z[:, 1:2], 0.1 * z[:, 2:]], 1)
        else:
            qpos = z
        return qpos, 0.01 * draws["qvel"], {}

    def _pole_cosines(self, qpos):
        """``xmat`` zz and xz of the pole bodies (skip world and cart)."""
        Rs = self.xmat(qpos)
        return Rs[:, 2:, 2, 2], Rs[:, 2:, 0, 2]

    def observe_dmc(self, qpos, qvel, extras):
        zz, xz = self._pole_cosines(qpos)
        position = torch.cat([qpos[:, :1], torch.stack([zz, xz], 2).flatten(1)], 1)
        return {"position": position, "velocity": qvel}

    def reward_dmc(self, qpos, qvel, action, extras):
        zz, _ = self._pole_cosines(qpos)
        cart = qpos[:, 0]
        if self._sparse:
            cart_in = rewards.tolerance(cart, self._CART_RANGE)
            angle_in = torch.prod(rewards.tolerance(zz, self._ANGLE_COSINE_RANGE), 1)
            return cart_in * angle_in
        upright = torch.mean((zz + 1) / 2, 1)
        centered = (1 + rewards.tolerance(cart, margin=2)) / 2
        small_control = (4 + _quadratic_control(action[:, 0])) / 5
        small_velocity = (1 + torch.amin(rewards.tolerance(qvel[:, 1:], margin=5), 1)) / 2
        return upright * small_control * small_velocity * centered


class WalkerEnv(DmcEnv):
    """walker:{stand,walk,run}."""

    DOMAIN = "walker"
    CONTROL_TIMESTEP = 0.025
    _STAND_HEIGHT = 1.2
    _SPEEDS = {"stand": 0.0, "walk": 1.0, "run": 8.0}

    def observe_dmc(self, qpos, qvel, extras):
        Rs = self.xmat(qpos)
        orientations = torch.stack([Rs[:, 1:, 0, 0], Rs[:, 1:, 0, 2]], 2).flatten(1)
        height = self.xpos(qpos)[:, self.body_index("torso"), 2]
        return {"orientations": orientations, "height": height[:, None], "velocity": qvel}

    def reward_dmc(self, qpos, qvel, action, extras):
        torso = self.body_index("torso")
        height = self.xpos(qpos)[:, torso, 2]
        upright = (1 + self.xmat(qpos)[:, torso, 2, 2]) / 2
        standing = rewards.tolerance(
            height, bounds=(self._STAND_HEIGHT, float("inf")), margin=self._STAND_HEIGHT / 2
        )
        stand_reward = (3 * standing + upright) / 4
        speed = self._SPEEDS[self.task]
        if speed == 0:
            return stand_reward
        move = rewards.tolerance(
            self.subtree_linvel_x(qpos, qvel),
            bounds=(speed, float("inf")),
            margin=speed / 2,
            value_at_margin=0.5,
            sigmoid="linear",
        )
        return stand_reward * (5 * move + 1) / 6


class HopperEnv(DmcEnv):
    """hopper:{stand,hop}.  The touch obs is ``log1p`` of the penalty
    normal force of the foot's first and last contact spheres (toe and
    heel), as the JAX env approximates the touch sensors."""

    DOMAIN = "hopper"
    CONTROL_TIMESTEP = 0.02
    _STAND_HEIGHT = 0.6
    _HOP_SPEED = 2.0

    def __init__(self, config):
        super().__init__(config)
        foot = self.body_index("foot")
        idx = np.nonzero(np.asarray(self.model.con_body) == foot)[0]
        self._touch_idx = [int(idx[0]), int(idx[-1])]

    def _height(self, qpos):
        coms = self.xipos(qpos)
        return coms[:, self.body_index("torso"), 2] - coms[:, self.body_index("foot"), 2]

    def _touch(self, qpos, qvel):
        mt = model_tensors(self.model, qpos.device, qpos.dtype)
        Rs, ps = self._fk(qpos)
        i = self._touch_idx
        centers = dynamics._contact_points(mt, Rs, ps)[:, i]
        v_con = self.velocities(qpos, qvel)[2][:, i]
        pen = mt.con_radius[i] - centers[..., 2]
        fn = torch.where(pen > 0, self.contact.kp * pen - self.contact.kd * v_con[..., 2], 0.0)
        return torch.log1p(torch.clamp_min(fn, 0.0))

    def observe_dmc(self, qpos, qvel, extras):
        return {
            "position": qpos[:, 1:],
            "velocity": qvel,
            "touch": self._touch(qpos, qvel),
        }

    def reward_dmc(self, qpos, qvel, action, extras):
        standing = rewards.tolerance(self._height(qpos), (self._STAND_HEIGHT, 2))
        if self.task == "hop":
            hopping = rewards.tolerance(
                self.subtree_linvel_x(qpos, qvel),
                bounds=(self._HOP_SPEED, float("inf")),
                margin=self._HOP_SPEED / 2,
                value_at_margin=0.5,
                sigmoid="linear",
            )
            return standing * hopping
        small_control = (torch.mean(_quadratic_control(action), 1) + 4) / 5
        return standing * small_control


class DmcReacherEnv(DmcEnv):
    """reacher:{easy,hard}, with a per-episode random target in ``extras``."""

    DOMAIN = "reacher"
    _SIZES = {"easy": 0.05, "hard": 0.015}

    def _extras_spec(self):
        return {"target": (2,)}

    def reset_draws(self, sub):
        """``joints`` of :meth:`randomize_joints`, the target's ``angle``
        uniform in ``[0, 2 pi)`` and ``radius`` in ``[0.05, 0.2)``."""
        nj = len(self._rand_joints)
        return {
            "joints": self.randomize_joints(sub),
            "angle": rng.uniform_range(sub, 0.0, 2 * math.pi, 1, slot=nj)[:, 0],
            "radius": rng.uniform_range(sub, 0.05, 0.20, 1, slot=nj + 1)[:, 0],
        }

    def init_state(self, draws):
        qpos, qvel, _ = super().init_state(draws)
        angle, radius = draws["angle"], draws["radius"]
        target = torch.stack([radius * torch.sin(angle), radius * torch.cos(angle)], 1)
        return qpos, qvel, {"target": target}

    def _finger_to_target(self, qpos, extras):
        return extras["target"] - self.xpos(qpos)[:, self.body_index("finger"), :2]

    def observe_dmc(self, qpos, qvel, extras):
        return {
            "position": qpos,
            "to_target": self._finger_to_target(qpos, extras),
            "velocity": qvel,
        }

    def reward_dmc(self, qpos, qvel, action, extras):
        radius = self._SIZES[self.task]
        dist = torch.linalg.vector_norm(self._finger_to_target(qpos, extras), dim=1)
        return rewards.tolerance(dist, (0, radius), margin=radius)


class DmcAcrobotEnv(DmcEnv):
    """acrobot:{swingup,swingup_sparse}."""

    DOMAIN = "acrobot"

    def reset_draws(self, sub):
        """``angles`` ``[N, 2]`` uniform in ``[-pi, pi)``: shoulder, elbow."""
        return {"angles": rng.uniform_range(sub, -math.pi, math.pi, 2)}

    def init_state(self, draws):
        angles = draws["angles"]
        qpos = self._qpos0.expand(angles.shape[0], -1).clone()
        qpos[:, :2] = angles
        return qpos, qpos.new_zeros(qpos.shape[0], self.model.nv), {}

    def observe_dmc(self, qpos, qvel, extras):
        Rs = self.xmat(qpos)
        ru = Rs[:, self.body_index("upper_arm")]
        rl = Rs[:, self.body_index("lower_arm")]
        orientations = torch.stack([ru[:, 0, 2], rl[:, 0, 2], ru[:, 2, 2], rl[:, 2, 2]], 1)
        return {"orientations": orientations, "velocity": qvel}

    def _to_target(self, qpos):
        names = self.model.site_names
        sp = site_positions(self.model, qpos)
        return torch.linalg.vector_norm(
            sp[:, names.index("target")] - sp[:, names.index("tip")], dim=1
        )

    def reward_dmc(self, qpos, qvel, action, extras):
        # The target site's radius: acrobot.xml's size 0.1, as the JAX env
        # has it (site sizes are not extracted).
        radius = 0.1
        margin = 0.0 if self.task.endswith("sparse") else 1.0
        return rewards.tolerance(self._to_target(qpos), bounds=(0, radius), margin=margin)


class PointMassEnv(DmcEnv):
    """point_mass:{easy,hard}: two slide joints driven through tendon
    transmissions.

    ``hard`` randomizes the actuation per episode, as the JAX env does:
    each control channel drives a random unit direction of the two joints
    (dm_control sets the tendons' ``wrap_prm`` to two random unit vectors
    with |cos| <= 0.9); the 2x2 matrix of the directions lives in
    ``extras`` and remaps the action.  JAX draws the second direction in a
    rejection loop; here each env draws ``CANDIDATES`` candidates and takes
    the first with |cos| <= 0.9 to the first direction.  A candidate fails
    with probability ~0.287, so all of them fail with ~2e-9; then the last
    one is taken, whatever its angle.
    """

    DOMAIN = "point_mass"
    _TARGET_SIZE = 0.015
    CANDIDATES = 16

    def _extras_spec(self):
        return {"gain": (2, 2)} if self.task == "hard" else {}

    def reset_draws(self, sub):
        """``joints`` of :meth:`randomize_joints`; for ``hard`` also
        ``dir1`` ``[N, 2]`` and ``dir2`` ``[N, CANDIDATES, 2]`` standard
        normal (directions before normalisation)."""
        draws = {"joints": self.randomize_joints(sub)}
        if self.task == "hard":
            nj = len(self._rand_joints)
            draws["dir1"] = rng.normal(sub, nj, 2)
            draws["dir2"] = rng.normal(sub, nj + 4, 2 * self.CANDIDATES).view(-1, self.CANDIDATES, 2)
        return draws

    def init_state(self, draws):
        qpos, qvel, _ = super().init_state(draws)
        extras = {}
        if self.task == "hard":
            dir1 = draws["dir1"] / torch.linalg.vector_norm(draws["dir1"], dim=-1, keepdim=True)
            cands = draws["dir2"] / torch.linalg.vector_norm(draws["dir2"], dim=-1, keepdim=True)
            ok = (cands * dir1[:, None]).sum(-1).abs() <= 0.9
            ok[:, -1] = True  # all rejected: the last candidate
            first = ok.to(torch.int8).argmax(1)
            dir2 = cands[torch.arange(len(first), device=first.device), first]
            # Columns are the actuation directions: ctrl = gain @ action.
            extras["gain"] = torch.stack([dir1, dir2], 2)
        return qpos, qvel, extras

    def transform_action(self, action, extras):
        if self.task == "hard":
            return _mv(extras["gain"], action)
        return action

    def observe_dmc(self, qpos, qvel, extras):
        return {"position": qpos, "velocity": qvel}

    def reward_dmc(self, qpos, qvel, action, extras):
        # The target geom sits at the origin (point_mass.xml).
        mass_pos = self.xpos(qpos)[:, self.body_index("pointmass"), :2]
        near = rewards.tolerance(
            torch.linalg.vector_norm(mass_pos, dim=1), (0, self._TARGET_SIZE),
            margin=self._TARGET_SIZE,
        )
        control = torch.mean(_quadratic_control(action), 1)
        return near * (control + 4) / 5


class SwimmerEnv(DmcEnv):
    """swimmer:{swimmer6,swimmer15}: dm_control's procedural n-link chain
    (``swimmer._make_model(n)``), propelled by MuJoCo's inertia-box fluid
    drag.  The target is a per-episode model edit in dm_control; here it
    lives in ``extras``.  Observations: the joints ``qpos[3:]``, nose to
    target in the head's frame (xy), and each body's local
    ``[vx, vy, wz]`` at its origin (the suite's velocimeter and gyro)."""

    DOMAIN = "swimmer"
    CONTROL_TIMESTEP = 0.03
    DEFAULT_CONFIG = dict(DmcEnv.DEFAULT_CONFIG, n_links=6)
    _TARGET_SIZE = 0.1

    def __init__(self, config):
        super().__init__(config)
        consts = load_constants(self.model_name())
        self._nose_body = int(consts["nose_body"])
        self._nose_off = torch.as_tensor(np.float32(consts["nose_offset"]), device=self.device)
        self._target_z = float(np.float32(consts["target_z"]))

    def model_name(self):
        return f"{super().model_name()}_{int(self.config['n_links'])}"

    def _extras_spec(self):
        return {"target": (2,)}

    def reset_draws(self, sub):
        """``joints`` of :meth:`randomize_joints`, ``close`` uniform in
        ``[0, 1)`` (a near target below 0.2) and ``target`` ``[N, 2]``
        uniform in ``[-1, 1)``."""
        nj = len(self._rand_joints)
        return {
            "joints": self.randomize_joints(sub),
            "close": rng.uniform(sub, nj),
            "target": rng.uniform_range(sub, -1.0, 1.0, 2, slot=nj + 1),
        }

    def init_state(self, draws):
        qpos, qvel, _ = super().init_state(draws)
        box = torch.where(draws["close"] < 0.2, 0.3, 2.0)
        return qpos, qvel, {"target": draws["target"] * box[:, None]}

    def _nose_to_target(self, qpos, extras):
        Rs, ps = self._fk(qpos)
        R, p = Rs[:, self._nose_body], ps[:, self._nose_body]
        nose = p + _mv(R, self._nose_off.to(qpos.dtype))
        z = extras["target"].new_full((qpos.shape[0], 1), self._target_z)
        target = torch.cat([extras["target"], z], 1)
        return _mv(R.transpose(1, 2), target - nose)[:, :2]

    def _body_velocities(self, qpos, qvel):
        v_com, omega, _ = self.velocities(qpos, qvel)
        Rs, ps = self._fk(qpos)
        coms = self.xipos(qpos)
        v_origin = v_com + torch.linalg.cross(omega, ps - coms)
        Rt = Rs.transpose(2, 3)
        v_local, w_local = _mv(Rt, v_origin), _mv(Rt, omega)
        out = torch.stack([v_local[..., 0], v_local[..., 1], w_local[..., 2]], 2)
        return out[:, 1:].flatten(1)  # skip the world

    def observe_dmc(self, qpos, qvel, extras):
        return {
            "joints": qpos[:, 3:],
            "to_target": self._nose_to_target(qpos, extras),
            "body_velocities": self._body_velocities(qpos, qvel),
        }

    def reward_dmc(self, qpos, qvel, action, extras):
        dist = torch.linalg.vector_norm(self._nose_to_target(qpos, extras), dim=1)
        return rewards.tolerance(
            dist, bounds=(0, self._TARGET_SIZE), margin=5 * self._TARGET_SIZE,
            sigmoid="long_tail",
        )
