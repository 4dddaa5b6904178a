"""Gym-MuJoCo env family base over the port's physics, batched-first.

Counterpart of ``envpool_tpu/envs/mujoco_gym/base.py`` (reference
``envpool/mujoco/gym/mujoco_env.h:45-267``).  The model's constants come
from ``physics.model.load_model`` (a committed data file for the default
XMLs; another model's ``xml_file`` is an ``.npz`` that
``tools/export_models.py --xml`` writes), and every step runs ``physics.dynamics.step`` over ``[N, ...]``
tensors.

The config is the JAX env's: ``frame_skip``, ``xml_file``,
``reset_noise_scale``, ``ctrl_cost_weight``, ``forward_reward_weight``,
``exclude_current_positions_from_observation``, ``integrator``, and the
penalty-contact extensions ``substeps`` / ``contact_kp`` / ``contact_kd``.
``frame_stack`` and ``post_constraint`` are accepted and unused, as there;
``contact_solver="mujoco"`` (with ``contact_sol_iters`` sweeps) steps the
ground contacts and joint limits with the constraint solver
(``physics/solver.py``).
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...physics.dynamics import ContactParams
from ...physics.model import load_model
from ..physics_env import PhysicsEnv


class MujocoGymEnv(PhysicsEnv):
    """Base for Gym-style locomotion tasks."""

    XML = ""
    FRAME_SKIP = 5
    # The default reset adds qvel noise drawn normal with standard
    # deviation ``reset_noise_scale`` (HalfCheetah, Ant and the double
    # pendulum); with this set, uniform within ``±reset_noise_scale``.
    UNIFORM_QVEL_NOISE = False

    def __init__(self, config):
        super().__init__(config)
        self.model = load_model(config["xml_file"] or self.XML)
        integ = str(config["integrator"])
        if integ != "model":
            # Euler with implicit damping is ~4x cheaper than RK4; "model"
            # keeps the XML's integrator.
            self.model = dataclasses.replace(
                self.model, integrator={"euler": 0, "rk4": 1}[integ]
            )
        fs = config["frame_skip"]
        self.frame_skip = int(type(self).FRAME_SKIP if fs is None else fs)
        self.dt = self.model.timestep * self.frame_skip
        self.contact = ContactParams(
            kp=float(config["contact_kp"]),
            kd=float(config["contact_kd"]),
            solver=str(config["contact_solver"]),
            sol_iters=int(config["contact_sol_iters"]),
        )
        self.substeps = int(config["substeps"])
        self._qpos0 = torch.as_tensor(
            self.model.qpos0, dtype=torch.float32, device=self.device
        )

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        base = {
            "frame_skip": cls.FRAME_SKIP,
            "frame_stack": 1,
            "post_constraint": True,
            "xml_file": "",
            "reset_noise_scale": 0.1,
            "ctrl_cost_weight": 0.1,
            "forward_reward_weight": 1.0,
            "exclude_current_positions_from_observation": True,
            "reward_threshold": 0.0,
            # penalty-contact extensions
            "substeps": 1,
            "contact_kp": 1.0e4,
            "contact_kd": 1.0e2,
            "contact_solver": "penalty",
            "contact_sol_iters": 40,
            "integrator": "model",  # "model" (the XML's) | "euler" | "rk4"
        }
        merged = dict(base)
        merged.update(cls.DEFAULT_CONFIG)
        # FRAME_SKIP on the final class is authoritative: None resolves to
        # it at init, so a DEFAULT_CONFIG copied from a parent class cannot
        # carry the parent's frame skip.
        if merged["frame_skip"] == cls.FRAME_SKIP:
            merged["frame_skip"] = None
        cls.DEFAULT_CONFIG = merged

    # -- per-task hooks ----------------------------------------------------

    def reset_draws(self, sub):
        """``qpos_noise`` ``[N, nq]`` uniform in ``[-s, s)`` and
        ``qvel_noise`` ``[N, nv]``, standard normal or, with
        ``UNIFORM_QVEL_NOISE``, uniform in ``[-s, s)``; ``s`` is the
        ``reset_noise_scale``.  Gym adds the qpos noise to every qpos
        coordinate, a free joint's quaternion included."""
        s = float(self.config["reset_noise_scale"])
        nq, nv = self.model.nq, self.model.nv
        if self.UNIFORM_QVEL_NOISE:
            qvel = rng.uniform_range(sub, -s, s, nv, slot=nq)
        else:
            qvel = rng.normal(sub, nq, nv)
        return {"qpos_noise": rng.uniform_range(sub, -s, s, nq), "qvel_noise": qvel}

    def reset_qpos_qvel(self, draws):
        """The reset state ``(qpos [N, nq], qvel [N, nv])`` from the draws
        of :meth:`reset_draws` (the JAX env's ``reset_qpos_qvel``)."""
        qvel = draws["qvel_noise"]
        if not self.UNIFORM_QVEL_NOISE:
            qvel = float(self.config["reset_noise_scale"]) * qvel
        return self._qpos0 + draws["qpos_noise"], qvel

    def observe(self, qpos, qvel):
        raise NotImplementedError

    def reward_done(self, before, after, action):
        """-> (reward [N], terminated [N], info dict of [N] tensors)."""
        raise NotImplementedError

    # -- TorchEnv contract -------------------------------------------------

    def state_spec(self):
        zeros = torch.zeros(1, self.model.nq), torch.zeros(1, self.model.nv)
        obs_dim = int(self.observe(*zeros).shape[1])
        inf = float("inf")
        spec = {
            "obs": ArraySpec(np.float32, (obs_dim,), -inf, inf),
            "info:qpos0": ArraySpec(np.float32, (self.model.nq,)),
            "info:qvel0": ArraySpec(np.float32, (self.model.nv,)),
        }
        spec.update(self.extra_info_spec())
        return spec

    def extra_info_spec(self):
        return {
            "info:reward_run": ArraySpec(np.float32, ()),
            "info:reward_ctrl": ArraySpec(np.float32, ()),
            "info:x_position": ArraySpec(np.float32, ()),
            "info:x_velocity": ArraySpec(np.float32, ()),
        }

    def action_spec(self):
        # Per-dim bounds from the model's ctrlrange (gymnasium's Box uses
        # the same source); ±1 for unlimited actuators.  Scalars only when
        # every actuator has the same range.
        cr = np.asarray(self.model.act_ctrlrange, np.float64)
        lim = np.asarray(self.model.act_ctrllimited, bool)
        low = np.where(lim, cr[:, 0], -1.0).astype(np.float32)
        high = np.where(lim, cr[:, 1], 1.0).astype(np.float32)
        if np.all(low == low[0]) and np.all(high == high[0]):
            return {
                "action": ArraySpec(
                    np.float32, (self.model.nu,), float(low[0]), float(high[0])
                )
            }
        return {"action": ArraySpec(np.float32, (self.model.nu,), low, high)}

    def obs_fields(self, state):
        return {"obs": self.observe(state["qpos"], state["qvel"])}

    def _obs_dict(self, st, info):
        out = {
            **self.obs_fields(st),
            "info:qpos0": st["qpos0"],
            "info:qvel0": st["qvel0"],
        }
        for k, v in info.items():
            out[f"info:{k}"] = v
        return out

    def reset_env(self, draws):
        qpos, qvel = self.reset_qpos_qvel(draws)
        st = {"qpos": qpos, "qvel": qvel, "qpos0": qpos, "qvel0": qvel}
        zero = qpos.new_zeros(qpos.shape[0])
        info = {k.replace("info:", ""): zero for k in self.extra_info_spec()}
        return st, self._obs_dict(st, info)

    def step_env(self, state, action, draws):
        action = action.reshape(-1, self.model.nu).to(torch.float32)
        qpos, qvel = state["qpos"], state["qvel"]
        new_qpos, new_qvel = self.physics_step(state, action)
        before = {"qpos": qpos, "qvel": qvel}
        after = {"qpos": new_qpos, "qvel": new_qvel}
        reward, terminated, info = self.reward_done(before, after, action)
        st = {
            "qpos": new_qpos,
            "qvel": new_qvel,
            "qpos0": state["qpos0"],
            "qvel0": state["qvel0"],
        }
        obs = self._obs_dict(st, info)
        return EnvOut(state=st, obs=obs, reward=reward, terminated=terminated)
