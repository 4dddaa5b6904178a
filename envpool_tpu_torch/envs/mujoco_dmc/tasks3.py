"""dm_control suite tasks, third group, batched: quadruped, manipulator and
stacker.

Counterpart of the quadruped, manipulator and stacker tasks of
``envpool_tpu/envs/mujoco_dmc/tasks3.py``, on the models that dm_control's
generators build for each task (``physics.model.ASSETS``,
``dmc:quadruped_<task>``, ``dmc:manipulator_<task>``, ``dmc:stacker_<n>``).
As there:

* quadruped's position actuators are affine-bias servos behind first-order
  activation filters (tau 0.1): the servo runs in the physics at every
  substep, the filter is integrated in closed form per control step, and
  the activations ride in ``extras``;
* escape's heightfield is taken as flat: the rangefinders read ones;
* the toes' force/torque sensors read the penalty contacts' normal force;
* manipulator and stacker start without dm_control's collision rejection,
  and their touch obs come from site-to-object distances.

dog (``tasks3.py``'s last domain) is in ``tasks4.py``, on the filter of
:class:`FilteredEnv`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import rng
from ...physics.dynamics import _contact_points, site_positions
from ...physics.kinematics import _mv, fk, model_tensors
from .base import DmcEnv
from .rewards import tolerance

_GRAVITY = (0.0, 0.0, -9.81)  # the accelerometer's offset, as in the JAX env


class FilteredEnv(DmcEnv):
    """What quadruped and dog share: a free torso, hinge obs, first-order
    activation filters on every actuator and an accelerometer.

    The filter (dyntype 2, tau = dynprm[0]) is integrated in closed form
    over one control step of constant control: the physics applies its mean
    activation, and its activation at the step's end rides in ``extras``
    with the torso's velocity before the step (the accelerometer's
    reference), as in the JAX envs."""

    def __init__(self, config):
        super().__init__(config)
        m, dev = self.model, self.device
        hinges = np.flatnonzero(np.asarray(m.jnt_type) == 3)
        self._hinge_qadr = torch.as_tensor(m.jnt_qposadr[hinges], dtype=torch.int64, device=dev)
        self._hinge_dadr = torch.as_tensor(m.jnt_dofadr[hinges], dtype=torch.int64, device=dev)
        self._torso = self.body_index("torso")
        tau = float(m.act_dynprm[0])
        control_dt = m.timestep * self.frame_skip
        self._control_dt = control_dt
        self._act_decay = float(np.exp(-control_dt / tau))
        self._act_mean_w = float(tau / control_dt * (1.0 - np.exp(-control_dt / tau)))

    def contact_rows(self, bodies) -> torch.Tensor:
        """``[len(bodies), nc]`` float32 0/1 table of the contact spheres on
        each body."""
        con_body = np.asarray(self.model.con_body)
        rows = np.stack([con_body == b for b in bodies])
        return torch.as_tensor(np.float32(rows), device=self.device)

    def _extras_spec(self):
        return {"act": (self.model.nu,), "prev_v": (3,)}

    def transform_action(self, action, extras):
        """The filter's mean activation over the control step."""
        return action + (extras["act"] - action) * self._act_mean_w

    def next_state(self, state, action, qpos, qvel):
        """The new coordinates, the activation at the step's end, and the
        torso's velocity before the step."""
        act = state["extras"]["act"]
        extras = {"act": action + (act - action) * self._act_decay,
                  "prev_v": self._torso_vel(state["qpos"], state["qvel"])}
        return {"qpos": qpos, "qvel": qvel, "extras": extras}

    def _body_vel(self, qpos, qvel, body: int):
        """``[N, 3]`` world velocity of a body frame's origin (JAX's
        ``body_vel``)."""
        v_com, omega, _ = self.velocities(qpos, qvel)
        return v_com[:, body] + torch.linalg.cross(
            omega[:, body], self.xpos(qpos)[:, body] - self.xipos(qpos)[:, body])

    def _torso_vel(self, qpos, qvel):
        return self._body_vel(qpos, qvel, self._torso)

    def _accelerometer(self, Rt, v, extras):
        """``[N, 3]``: the torso's acceleration over the last step less
        gravity, in the torso's frame (``Rt``, the torso's rotation
        transposed; ``v``, its velocity now)."""
        g = torch.tensor(_GRAVITY, dtype=v.dtype, device=v.device)
        return _mv(Rt, (v - extras["prev_v"]) / self._control_dt - g)

    def contact_normals(self, qpos, rows) -> torch.Tensor:
        """``[N, k]``: the penalty contacts' normal force summed over each
        row of a ``contact_rows`` table."""
        mt = model_tensors(self.model, qpos.device, qpos.dtype)
        pen = mt.con_radius - _contact_points(mt, *self._fk(qpos))[..., 2]
        return torch.clamp_min(self.contact.kp * pen, 0.0) @ rows.T.to(qpos.dtype)


class QuadrupedEnv(FilteredEnv):
    """quadruped:{walk,run,escape,fetch}."""

    DOMAIN = "quadruped"
    CONTROL_TIMESTEP = 0.02
    DEFAULT_CONFIG = dict(DmcEnv.DEFAULT_CONFIG, substeps=2)
    _TOES = ("toe_front_left", "toe_back_left", "toe_back_right", "toe_front_right")
    _SPEEDS = {"walk": 0.5, "run": 5.0}

    def model_name(self):
        return f"{super().model_name()}_{self.config['task_name'] or 'walk'}"

    def __init__(self, config):
        super().__init__(config)
        m = self.model
        # The toes' contact spheres, as a [4, nc] 0/1 table.
        self._toe_rows = self.contact_rows([self.body_index(t) for t in self._TOES])
        ws = self.site_index("workspace")
        self._workspace_body = int(m.site_body[ws])
        self._workspace_local = m.site_pos[ws]
        self._workspace_r = float(self.consts["site_size"][ws][0])
        if self.task == "escape":
            self._terrain_size = float(self.consts["hfield_size"][0][0])
            self._n_rf = int(self.consts["n_rangefinder"])
        if self.task == "fetch":
            self._ball = self.body_index("ball")
            root = self.joint_index("ball_root")
            self._ball_qadr = int(m.jnt_qposadr[root])
            self._ball_dadr = int(m.jnt_dofadr[root])
            self._target_r = float(self.consts["site_size"][self.site_index("target")][0])
            self._arena_radius = float(m.geom_size[self.geom_index("floor")][0]) * np.sqrt(2)
            self._ball_r = float(m.geom_size[self.geom_index("ball")][0])
        # The JAX env makes its own contact constants: pairs for fetch only.
        self.contact = self.contact._replace(pairs=self.task == "fetch")

    # -- episode start -----------------------------------------------------

    def _spawn(self) -> float:
        """fetch's half-width of the square the torso and the ball start in."""
        return 0.5 * self._arena_radius / np.sqrt(2)

    def reset_draws(self, sub):
        """walk, run, escape: ``quat`` ``[N, 4]`` standard normal (the
        torso's orientation before normalisation).  fetch: the torso's
        ``azimuth`` ``[N]`` uniform in ``[0, 2 pi)``, its ``xy`` and the
        ball's ``ball_xy`` ``[N, 2]`` uniform in ``[-spawn, spawn)``."""
        if self.task != "fetch":
            return {"quat": rng.normal(sub, 0, 4)}
        s = self._spawn()
        return {"azimuth": rng.uniform_range(sub, 0.0, 2 * math.pi, 1)[:, 0],
                "xy": rng.uniform_range(sub, -s, s, 2, slot=1),
                "ball_xy": rng.uniform_range(sub, -s, s, 2, slot=3)}

    def drop_height(self, qpos):
        """``[N]`` float32: the JAX env's ``_drop_height``: the clearance of
        the lowest contact sphere at ``qpos``, up to a 1 cm grid, plus 1 cm.

        The clearance is measured at the height ``qpos`` holds (``qpos0``'s
        0.57), and the result replaces that height, as in the JAX env.  The
        grid cell is found in float64, so that the card and the CPU pick
        the same one (a float32 rounding at a grid line would move z by
        1 cm); the height ``cells · 0.01 + 0.01`` (float32 constants) is
        rounded to float32 once, as XLA's fused multiply-add rounds JAX's."""
        cells = torch.ceil(torch.clamp_min(self.clearance_cells(qpos), 0.0))
        cm = float(np.float32(0.01))
        return (cells * cm + cm).float()

    def clearance_cells(self, qpos):
        """``[N]`` float64: how far the lowest contact sphere at ``qpos``
        lies below the floor, in 1 cm cells."""
        q = qpos.double()
        mt = model_tensors(self.model, q.device, q.dtype)
        centers = _contact_points(mt, *fk(self.model, q))
        return -(centers[..., 2] - mt.con_radius).amin(1) / 0.01

    def init_state(self, draws):
        nq, n = self.model.nq, next(iter(draws.values())).shape[0]
        qpos = self._qpos0.expand(n, nq).clone()
        if self.task == "fetch":
            half = draws["azimuth"] / 2
            zero = torch.zeros_like(half)
            quat = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], 1)
            qpos[:, 0:2] = draws["xy"]
        else:
            quat = draws["quat"] / torch.linalg.vector_norm(draws["quat"], dim=1, keepdim=True)
        qpos[:, 3:7] = quat
        qpos[:, 2] = self.drop_height(qpos)
        if self.task == "fetch":
            qpos[:, self._ball_qadr:self._ball_qadr + 2] = draws["ball_xy"]
            qpos[:, self._ball_qadr + 2] = 2.0
        extras = {"act": qpos.new_zeros(n, self.model.nu), "prev_v": qpos.new_zeros(n, 3)}
        return qpos, qpos.new_zeros(n, self.model.nv), extras

    # -- observables -------------------------------------------------------

    def _force_torque(self, qpos):
        """``[N, 24]``: arcsinh of each toe's force and torque, the force the
        summed penalty normal force on z and the rest zero."""
        f = self.contact_normals(qpos, self._toe_rows)
        out = qpos.new_zeros(qpos.shape[0], 4, 6)
        out[:, :, 2] = f
        return torch.arcsinh(out.flatten(1))

    def observe_dmc(self, qpos, qvel, extras):
        R = self.xmat(qpos)[:, self._torso]
        Rt = R.transpose(1, 2)
        v = self._torso_vel(qpos, qvel)
        obs = {
            "egocentric_state": torch.cat(
                [qpos[:, self._hinge_qadr], qvel[:, self._hinge_dadr], extras["act"]], 1),
            "torso_velocity": _mv(Rt, v),
            "torso_upright": R[:, 2, 2],
            "imu": torch.cat([qvel[:, 3:6], self._accelerometer(Rt, v, extras)], 1),
            "force_torque": self._force_torque(qpos),
        }
        ps = self.xpos(qpos)
        if self.task == "escape":
            obs["origin"] = -_mv(Rt, ps[:, self._torso])
            obs["rangefinder"] = qpos.new_ones(qpos.shape[0], self._n_rf)
        if self.task == "fetch":
            b = self._ball_dadr
            rel = torch.stack([ps[:, self._ball] - ps[:, self._torso],
                               qvel[:, b:b + 3] - qvel[:, 0:3], qvel[:, b + 3:b + 6]], 1)
            obs["ball_state"] = (rel @ R).flatten(1)
            obs["target_position"] = _mv(Rt, -ps[:, self._torso])  # the target site is at the origin
        return obs

    # -- rewards -----------------------------------------------------------

    def _upright_reward(self, qpos, deviation_angle=0.0):
        deviation = float(np.cos(np.deg2rad(deviation_angle)))
        return tolerance(self.xmat(qpos)[:, self._torso, 2, 2], bounds=(deviation, float("inf")),
                         sigmoid="linear", margin=1 + deviation, value_at_margin=0.0)

    def reward_dmc(self, qpos, qvel, action, extras):
        if self.task in self._SPEEDS:
            speed = self._SPEEDS[self.task]
            R = self.xmat(qpos)[:, self._torso]
            vx = _mv(R.transpose(1, 2), self._torso_vel(qpos, qvel))[:, 0]
            move = tolerance(vx, bounds=(speed, float("inf")), margin=speed,
                             value_at_margin=0.5, sigmoid="linear")
            return self._upright_reward(qpos) * move
        ws = self._points(qpos, self._workspace_body, self._workspace_local)
        if self.task == "escape":
            escape = tolerance(torch.linalg.vector_norm(ws, dim=1),
                               bounds=(self._terrain_size, float("inf")),
                               margin=self._terrain_size, value_at_margin=0.0, sigmoid="linear")
            return self._upright_reward(qpos, 20.0) * escape
        ball = self.xpos(qpos)[:, self._ball]
        reach = tolerance(torch.linalg.vector_norm((ws - ball)[:, :2], dim=1),
                          bounds=(0.0, self._workspace_r + self._ball_r), sigmoid="linear",
                          margin=self._arena_radius, value_at_margin=0.0)
        fetch = tolerance(torch.linalg.vector_norm(ball[:, :2], dim=1),  # target at the origin
                          bounds=(0.0, self._target_r), sigmoid="linear",
                          margin=self._arena_radius, value_at_margin=0.0)
        return self._upright_reward(qpos) * reach * (0.5 + 0.5 * fetch)


_ARM_JOINTS = ("arm_root", "arm_shoulder", "arm_elbow", "arm_wrist",
               "finger", "fingertip", "thumb", "thumbtip")
_TOUCH_SITES = ("palm_touch", "finger_touch", "thumb_touch",
                "fingertip_touch", "thumbtip_touch")


class _PlanarArmEnv(DmcEnv):
    """What manipulator and stacker share: the planar 8-joint arm, contact
    pairs, touch and 2D poses."""

    CONTROL_TIMESTEP = 0.01
    DEFAULT_CONFIG = dict(DmcEnv.DEFAULT_CONFIG, substeps=2)

    def __init__(self, config):
        super().__init__(config)
        m, dev = self.model, self.device
        joints = [self.joint_index(n) for n in _ARM_JOINTS]
        self._arm_qadr = torch.as_tensor(m.jnt_qposadr[joints], dtype=torch.int64, device=dev)
        self._arm_dadr = torch.as_tensor(m.jnt_dofadr[joints], dtype=torch.int64, device=dev)
        limited = np.asarray(m.jnt_limited)[joints]
        rng_ = np.asarray(m.jnt_range)[joints]
        self._arm_lo, self._arm_hi = (
            torch.as_tensor(np.where(limited, rng_[:, i], sign * np.pi).astype(np.float32),
                            device=dev)
            for i, sign in ((0, -1), (1, 1)))
        self._finger_j = _ARM_JOINTS.index("finger")
        self._thumb_j = _ARM_JOINTS.index("thumb")
        self._hand_body = self.body_index("hand")
        self._grasp_site = self.site_index("grasp")
        if "pinch" in m.site_names:
            self._pinch_site = self.site_index("pinch")
        self._touch_sites = [self.site_index(s) for s in _TOUCH_SITES if s in m.site_names]
        self.contact = self.contact._replace(pairs=True)

    def _sites(self, qpos):
        """``[N, ns, 3]`` site positions, once per state."""
        memo = getattr(self, "_site_memo", None)
        if memo is None or memo[0] is not qpos:
            memo = self._site_memo = (qpos, site_positions(self.model, qpos))
        return memo[1]

    def _arm_values(self, u):
        """``[N, 8]`` arm joints from unit draws ``u``: uniform in each
        joint's range, the finger set to the thumb (a symmetric hand)."""
        vals = self._arm_lo + (self._arm_hi - self._arm_lo) * u
        vals[:, self._finger_j] = vals[:, self._thumb_j]
        return vals

    def _body_2d_pose(self, qpos, body):
        """``[N, 4]``: ``[x, z, qw, qy]`` of a body turning about y."""
        Rs, ps = self._fk(qpos)
        theta = torch.atan2(Rs[:, body, 0, 2], Rs[:, body, 0, 0])
        return torch.stack([ps[:, body, 0], ps[:, body, 2],
                            torch.cos(theta / 2), torch.sin(theta / 2)], 1)

    def _touch(self, qpos, centers, radius):
        """``[N, 5]`` log1p pseudo-touch: how far each touch site lies
        inside ``radius + 0.02`` of the nearest object centre
        (``centers`` ``[N, k, 3]``), times 1e3."""
        sites = self._sites(qpos)[:, self._touch_sites]
        d = torch.linalg.vector_norm(centers[:, None] - sites[:, :, None], dim=-1).amin(2)
        return torch.log1p(torch.clamp_min(radius + 0.02 - d, 0.0) * 1e3)

    def _arm_obs(self, qpos, qvel):
        ang = qpos[:, self._arm_qadr]
        return {"arm_pos": torch.stack([torch.sin(ang), torch.cos(ang)], -1),
                "arm_vel": qvel[:, self._arm_dadr]}


class ManipulatorEnv(_PlanarArmEnv):
    """manipulator:{bring_ball,bring_peg,insert_ball,insert_peg}.

    The start mirrors the JAX env's draws: the target's angle reuses the
    unit draw of its x (insert) or of its z (bring), and the object's
    uniform angle and its x speed share one draw, so each pair moves
    together (dm_control draws them apart).  The receptacle is for the
    reward alone: it has no contact."""

    DOMAIN = "manipulator"

    def model_name(self):
        return f"{super().model_name()}_{self.config['task_name'] or 'bring_ball'}"

    def __init__(self, config):
        task = str(config["task_name"]) or "bring_ball"
        self._use_peg = "peg" in task
        self._insert = task.startswith("insert")
        super().__init__(config)
        m, dev = self.model, self.device
        obj = "peg" if self._use_peg else "ball"
        self._object_body = self.body_index(obj)
        joints = [self.joint_index(f"{obj}_{d}") for d in "xzy"]
        self._obj_qadr = torch.as_tensor(m.jnt_qposadr[joints], dtype=torch.int64, device=dev)
        self._obj_dadr = torch.as_tensor(m.jnt_dofadr[joints], dtype=torch.int64, device=dev)
        self._obj_body_pos = m.body_pos[self._object_body]
        # The peg model has no geom "peg": the JAX env's name lookup gives
        # -1 there, so its radius is the last geom's, as here.
        geoms = list(self.consts["geom_names"])
        self._obj_r = float(m.geom_size[geoms.index(obj) if obj in geoms else -1][0])
        self._target_sites = {s: m.site_pos[self.site_index(s)]
                              for s in ("target_peg", "target_peg_tip", "target_ball")
                              if s in m.site_names}
        self._obj_sites = {s: self.site_index(s)
                           for s in ("peg", "peg_grasp", "peg_pinch", "peg_tip", "ball")
                           if s in m.site_names}

    def _extras_spec(self):
        return {"target": (3,)}  # (x, z, angle)

    def reset_draws(self, sub):
        """Unit draws uniform in ``[0, 1)``: ``arm`` ``[N, 8]``, ``target``
        ``[N, 2]`` (x, z), ``mode`` ``[N]`` (in hand below 0.1, in the
        target below 0.2, else free) and ``object`` ``[N, 3]`` (x, z, and
        the angle that also gives the x speed)."""
        return {"arm": rng.uniform(sub, 0, 8), "target": rng.uniform(sub, 8, 2),
                "mode": rng.uniform(sub, 10), "object": rng.uniform(sub, 11, 3)}

    def init_state(self, draws):
        n = draws["mode"].shape[0]
        qpos = self._qpos0.expand(n, -1).clone()
        qpos[:, self._arm_qadr] = self._arm_values(draws["arm"])
        tu, ou, u = draws["target"], draws["object"], draws["mode"]
        target_x = tu[:, 0] * 0.8 - 0.4
        target_z = tu[:, 1] * 0.3 + 0.1
        if self._insert:
            target_angle = tu[:, 0] * (2 * math.pi / 3) - math.pi / 3
        else:
            target_angle = tu[:, 1] * (2 * math.pi) - math.pi
        target = torch.stack([target_x, target_z, target_angle], 1)
        # (not the memo of _sites: qpos changes in place below)
        grasp = site_positions(self.model, qpos)[:, self._grasp_site]
        uni = torch.stack([ou[:, 0] - 0.5, ou[:, 1] * 0.7, ou[:, 2] * (2 * math.pi)], 1)
        in_hand = torch.stack([grasp[:, 0], grasp[:, 2], torch.zeros_like(u)], 1)
        obj = torch.where((u < 0.1)[:, None], in_hand,
                          torch.where((u < 0.2)[:, None], target, uni))
        # The object's joints are relative to its body's position.
        offset = torch.tensor([self._obj_body_pos[0], self._obj_body_pos[2], 0.0],
                              dtype=torch.float32, device=qpos.device)
        qpos[:, self._obj_qadr] = obj - offset
        qvel = qpos.new_zeros(n, self.model.nv)
        qvel[:, self._obj_dadr[0]] = torch.where(u >= 0.2, ou[:, 2] * 10.0 - 5.0, 0.0)
        return qpos, qvel, {"target": target}

    def _target_site_pos(self, extras, name):
        """``[N, 3]`` world position of a site of the (posed) target."""
        local = self._target_sites.get(name, np.zeros(3))
        t = extras["target"]
        c, s = torch.cos(t[:, 2]), torch.sin(t[:, 2])
        lx, lz = float(local[0]), float(local[2])
        return torch.stack([t[:, 0] + c * lx + s * lz, torch.zeros_like(c),
                            t[:, 1] - s * lx + c * lz], 1)

    def observe_dmc(self, qpos, qvel, extras):
        obs = self._arm_obs(qpos, qvel)
        center = self.xpos(qpos)[:, self._object_body]
        obs["touch"] = self._touch(qpos, center[:, None], self._obj_r)
        obs["hand_pos"] = self._body_2d_pose(qpos, self._hand_body)
        obs["object_pos"] = self._body_2d_pose(qpos, self._object_body)
        obs["object_vel"] = qvel[:, self._obj_dadr]
        t = extras["target"]
        obs["target_pos"] = torch.stack(
            [t[:, 0], t[:, 1], torch.cos(t[:, 2] / 2), torch.sin(t[:, 2] / 2)], 1)
        return obs

    def reward_dmc(self, qpos, qvel, action, extras):
        sites = self._sites(qpos)

        def close(a, b):
            return tolerance(torch.linalg.vector_norm(a - b, dim=1), (0.0, 0.01), margin=0.02)

        o = self._obj_sites
        if self._use_peg:
            grasping = (close(sites[:, o["peg_grasp"]], sites[:, self._grasp_site])
                        + close(sites[:, o["peg_pinch"]], sites[:, self._pinch_site])) / 2
            bringing = (close(sites[:, o["peg"]], self._target_site_pos(extras, "target_peg"))
                        + close(sites[:, o["peg_tip"]],
                                self._target_site_pos(extras, "target_peg_tip"))) / 2
            return torch.maximum(bringing, grasping / 3)
        return close(sites[:, o["ball"]], self._target_site_pos(extras, "target_ball"))


class StackerEnv(_PlanarArmEnv):
    """stacker:{stack_2,stack_4}."""

    DOMAIN = "stacker"

    def model_name(self):
        return f"{super().model_name()}_{self._n_boxes}"

    def __init__(self, config):
        self._n_boxes = int((str(config["task_name"]) or "stack_2").split("_")[1])
        super().__init__(config)
        m, dev = self.model, self.device
        self._box_bodies = [self.body_index(f"box{b}") for b in range(self._n_boxes)]
        joints = [[self.joint_index(f"box{b}_{d}") for d in "xzy"] for b in range(self._n_boxes)]
        self._box_qadr = torch.as_tensor(m.jnt_qposadr[joints], dtype=torch.int64, device=dev)
        self._box_dadr = torch.as_tensor(m.jnt_dofadr[joints], dtype=torch.int64, device=dev)
        # [n, 3]: what the box joints' x and z are relative to (y: nothing)
        pos = np.asarray(m.body_pos)[self._box_bodies]
        self._box_offset = torch.as_tensor(
            np.float32(np.stack([pos[:, 0], pos[:, 2], 0 * pos[:, 0]], 1)), device=dev)
        self._box_size = float(m.geom_size[self.geom_index("target")][0])
        self._box_sites = [self.site_index(f"box{b}") for b in range(self._n_boxes)]

    def _extras_spec(self):
        return {"target": (2,)}  # (x, z)

    def reset_draws(self, sub):
        """Unit draws for ``arm`` ``[N, 8]``; the target's ``height``
        ``[N]`` uniform in ``[0, n_boxes)`` and ``target_x`` in ``[-0.37,
        0.37)``; ``boxes`` ``[N, n_boxes, 3]``: x uniform in ``[0.1,
        0.3)``, z in ``[0, 0.7)``, the angle in ``[0, 2 pi)``."""
        n = self._n_boxes
        lo = torch.tensor([0.1, 0.0, 0.0], device=sub.device)
        hi = torch.tensor([0.3, 0.7, 2 * math.pi], device=sub.device)
        boxes = lo + (hi - lo) * rng.uniform(sub, 10, 3 * n).view(-1, n, 3)
        return {"arm": rng.uniform(sub, 0, 8), "height": rng.randint(sub, 8, n),
                "target_x": rng.uniform_range(sub, -0.37, 0.37, 1, slot=9)[:, 0],
                "boxes": boxes}

    def init_state(self, draws):
        boxes = draws["boxes"]
        n = boxes.shape[0]
        qpos = self._qpos0.expand(n, -1).clone()
        qpos[:, self._arm_qadr] = self._arm_values(draws["arm"])
        qpos[:, self._box_qadr.flatten()] = (boxes - self._box_offset).flatten(1)
        height = (2 * draws["height"] + 1).to(torch.float32)
        target = torch.stack([draws["target_x"], self._box_size * height], 1)
        return qpos, qpos.new_zeros(n, self.model.nv), {"target": target}

    def observe_dmc(self, qpos, qvel, extras):
        obs = self._arm_obs(qpos, qvel)
        centers = self.xpos(qpos)[:, self._box_bodies]
        obs["touch"] = self._touch(qpos, centers, self._box_size)
        obs["hand_pos"] = self._body_2d_pose(qpos, self._hand_body)
        obs["box_pos"] = torch.cat([self._body_2d_pose(qpos, b) for b in self._box_bodies], 1)
        obs["box_vel"] = qvel[:, self._box_dadr.flatten()]
        obs["target_pos"] = extras["target"]
        return obs

    def reward_dmc(self, qpos, qvel, action, extras):
        sites = self._sites(qpos)
        t = extras["target"]
        target = torch.stack([t[:, 0], torch.zeros_like(t[:, 0]), t[:, 1]], 1)
        dists = torch.linalg.vector_norm(sites[:, self._box_sites] - target[:, None], dim=-1)
        box_is_close = tolerance(dists.amin(1), margin=2 * self._box_size)
        hand_to_target = torch.linalg.vector_norm(sites[:, self._grasp_site] - target, dim=1)
        hand_is_far = tolerance(hand_to_target, bounds=(0.1, float("inf")), margin=0.01)
        return box_is_close * hand_is_far
