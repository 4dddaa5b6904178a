"""dm_control suite env family base over the port's physics, batched-first.

Counterpart of ``envpool_tpu/envs/mujoco_dmc/base.py`` (reference
``envpool/mujoco/dmc/mujoco_env.h:90-127``).  The models are the suite's
XMLs committed as data (``physics.model.ASSETS``, ``dmc:<domain>``), so
neither ``mujoco`` nor ``dm_control`` is needed.  Each control step runs
``frame_skip = round(CONTROL_TIMESTEP / timestep)`` physics steps;
episodes end only at the time limit, with discount 1.0.

The config is the JAX env's: ``task_name``, ``substeps``, ``contact_kp`` /
``contact_kd`` (2e4 / 2e2, stiffer than Gym-MuJoCo's) and
``contact_solver`` / ``contact_sol_iters`` (``"mujoco"``: the constraint
solver, ``physics/solver.py``).  A reset's randomness comes from
:meth:`reset_draws`; the tasks map the draws to a state the way the JAX
tasks map their threefry draws.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut
from ...core.specs import ArraySpec
from ...physics.dynamics import (
    ContactParams,
    _kin,
    _vel_from_kin,
    mass_matrix,
)
from ...physics.kinematics import _mv, fk, model_tensors
from ...physics.model import HINGE, SLIDE, load_constants, load_model
from ..physics_env import PhysicsEnv

# A model whose joint-space inertia at ``qpos0`` is conditioned worse than
# this steps in float64: rounding the mass matrix to float32 alone moves a
# step's accelerations by ~cond x 6e-8, and past ~1e5 a float32 env step
# lands farther than the one-step bar (1e-4) from float64 on most states
# (swimmer15: cond 1.8e5; swimmer6, the next worst, 2.2e4;
# tests/test_torch_mujoco_dmc.py::test_physics_dtype).  JAX's own float32
# step of swimmer15 lands as far from its float64 step; the port's step is
# held to JAX's float64 step (::test_swimmer15_float64_step_matches_jax_x64).
COND_FLOAT64 = 1e5


class DmcEnv(PhysicsEnv):
    """Base for dm_control suite tasks."""

    DOMAIN = ""
    CONTROL_TIMESTEP: float | None = None  # None: the physics timestep
    DEFAULT_CONFIG: dict[str, Any] = {
        "task_name": "",
        "substeps": 1,
        "contact_kp": 2.0e4,
        "contact_kd": 2.0e2,
        "contact_solver": "penalty",
        "contact_sol_iters": 40,
    }

    def __init__(self, config):
        super().__init__(config)
        self.model = load_model(self.model_name())
        # The JAX env's n_sub_steps: physics steps per control step.
        ct = self.CONTROL_TIMESTEP or self.model.timestep
        self.frame_skip = max(1, round(ct / self.model.timestep))
        self.contact = ContactParams(
            kp=float(config["contact_kp"]),
            kd=float(config["contact_kd"]),
            solver=str(config["contact_solver"]),
            sol_iters=int(config["contact_sol_iters"]),
        )
        self.substeps = int(config["substeps"])
        self.task = str(config["task_name"])
        m = self.model
        if self.mass_condition() > COND_FLOAT64:
            self.physics_dtype = torch.float64
        self._qpos0 = torch.as_tensor(m.qpos0, dtype=torch.float32, device=self.device)
        # randomize_limited_and_rotational_joints: limited hinges and slides
        # in their range, unlimited hinges in [-pi, pi); the rest kept.
        lo, hi, rand = [], [], []
        for j, jtype in enumerate(m.jnt_type):
            limited = bool(m.jnt_limited[j])
            if jtype in (SLIDE, HINGE) and (limited or jtype == HINGE):
                rand.append(j)
                lo.append(m.jnt_range[j][0] if limited else -np.pi)
                hi.append(m.jnt_range[j][1] if limited else np.pi)
        self._rand_joints = torch.as_tensor(rand, dtype=torch.int64, device=self.device)
        self._rand_qadr = torch.as_tensor(
            m.jnt_qposadr[rand], dtype=torch.int64, device=self.device
        )
        self._rand_lo, self._rand_hi = (
            torch.as_tensor(np.float32(v), device=self.device) for v in (lo, hi)
        )
        self._fk_memo = self._vel_memo = None

    def mass_condition(self) -> float:
        """The condition number of the joint-space inertia at ``qpos0``."""
        q0 = torch.as_tensor(self.model.qpos0, dtype=torch.float64)[None]
        ev = torch.linalg.eigvalsh(mass_matrix(self.model, q0))[0]
        return float(ev[-1] / ev[0])

    def model_name(self) -> str:
        """The model's key in ``physics.model.ASSETS``; the procedural
        domains (n-pole cartpole, n-link swimmer) override it."""
        return f"dmc:{self.DOMAIN}"

    # -- randomizers -------------------------------------------------------

    def randomize_joints(self, sub: torch.Tensor, slot: int = 0) -> torch.Tensor:
        """``[N, nj]`` joint values of ``randomizers.
        randomize_limited_and_rotational_joints``, one uniform draw per
        joint from slot ``slot`` on; the columns of joints it keeps are 0."""
        n, nj = sub.shape[0], len(self.model.jnt_type)
        joints = torch.zeros(n, nj, dtype=torch.float32, device=sub.device)
        if len(self._rand_joints):
            u = rng.uniform(sub, slot, len(self._rand_joints))
            joints[:, self._rand_joints] = self._rand_lo + (self._rand_hi - self._rand_lo) * u
        return joints

    def joint_qpos(self, joints: torch.Tensor) -> torch.Tensor:
        """``[N, nq]``: ``qpos0`` with the randomized joints of
        :meth:`randomize_joints` set to ``joints`` ``[N, nj]``."""
        qpos = self._qpos0.expand(joints.shape[0], -1).clone()
        qpos[:, self._rand_qadr] = joints[:, self._rand_joints]
        return qpos

    # -- kinematic helpers -------------------------------------------------

    def body_index(self, name: str) -> int:
        return self.model.body_names.index(name)

    @functools.cached_property
    def consts(self) -> dict[str, np.ndarray]:
        """The task constants committed beside the model (``load_constants``;
        joint and geom names, site sizes, ... where the task reads them)."""
        return load_constants(self.model_name())

    def joint_index(self, name: str) -> int:
        return list(self.consts["joint_names"]).index(name)

    def geom_index(self, name: str) -> int:
        return list(self.consts["geom_names"]).index(name)

    def site_index(self, name: str) -> int:
        return self.model.site_names.index(name)

    def _points(self, qpos, body: int, local) -> torch.Tensor:
        """``[N, 3]`` world position of the point ``local`` (body frame)."""
        Rs, ps = self._fk(qpos)
        local = torch.as_tensor(np.float32(local), device=qpos.device).to(qpos.dtype)
        return ps[:, body] + _mv(Rs[:, body], local)

    def _fk(self, qpos):
        """``(Rs [N, nb, 3, 3], ps [N, nb, 3])`` of the last ``qpos`` asked
        for, computed once: an obs and a reward read the same tree pass."""
        memo = self._fk_memo
        if memo is None or memo[0] is not qpos:
            memo = self._fk_memo = (qpos, *fk(self.model, qpos))
        return memo[1], memo[2]

    def xmat(self, qpos):
        """Body rotation matrices ``[N, nb, 3, 3]`` (MuJoCo's ``xmat``)."""
        return self._fk(qpos)[0]

    def xpos(self, qpos):
        """Body frame origins ``[N, nb, 3]`` (MuJoCo's ``xpos``)."""
        return self._fk(qpos)[1]

    def xipos(self, qpos):
        """Body centres of mass ``[N, nb, 3]`` (MuJoCo's ``xipos``)."""
        Rs, ps = self._fk(qpos)
        mt = model_tensors(self.model, qpos.device, qpos.dtype)
        return ps + _mv(Rs, mt.body_ipos)

    def velocities(self, qpos, qvel):
        """``(v_com [N, nb, 3], ω [N, nb, 3], v_con [N, nc, 3])``: the
        bodies' CoM and angular velocities and the contact spheres'
        velocities (JAX's ``_vel_observables``), computed once per state."""
        memo = self._vel_memo
        if memo is None or memo[0] is not qpos or memo[1] is not qvel:
            mt = model_tensors(self.model, qpos.device, qpos.dtype)
            vel = _vel_from_kin(mt, _kin(self.model, qpos), qvel)
            memo = self._vel_memo = (qpos, qvel, *vel)
        return memo[2:]

    def subtree_linvel_x(self, qpos, qvel):
        """``[N]`` x component of the whole robot's CoM velocity (the
        ``subtreelinvel`` sensor of the root)."""
        v_com = self.velocities(qpos, qvel)[0]
        m = torch.as_tensor(self.model.body_mass, dtype=qpos.dtype, device=qpos.device)
        return (v_com[..., 0] @ m) / m.sum()

    # -- task hooks --------------------------------------------------------

    def reset_draws(self, sub):
        """``joints`` ``[N, nj]`` of :meth:`randomize_joints`."""
        return {"joints": self.randomize_joints(sub)}

    def init_state(self, draws):
        """``(qpos [N, nq], qvel [N, nv], extras)`` at episode start."""
        qpos = self.joint_qpos(draws["joints"])
        return qpos, qpos.new_zeros(qpos.shape[0], self.model.nv), {}

    def observe_dmc(self, qpos, qvel, extras):
        """Ordered dict of ``[N, ...]`` obs (keys become ``obs:<key>``)."""
        raise NotImplementedError

    def reward_dmc(self, qpos, qvel, action, extras):
        raise NotImplementedError

    def transform_action(self, action, extras):
        """Hook for per-episode actuation remaps (point_mass:hard)."""
        del extras
        return action

    def terminated_dmc(self, qpos, qvel, extras):
        """Hook: ``[N]`` bools of task termination, or None (the time limit
        only, dm_control's default for the benchmarking suite)."""
        del qpos, qvel, extras
        return None

    def _extras_spec(self) -> dict[str, tuple]:
        """Shapes of extra per-episode state (e.g. target positions)."""
        return {}

    # -- PhysicsEnv and TorchEnv contract ----------------------------------

    def control(self, state, action):
        return self.transform_action(action, state["extras"])

    def obs_fields(self, state):
        qpos = state["qpos"]
        obs = self.observe_dmc(qpos, state["qvel"], state["extras"])
        return {f"obs:{k}": v.to(qpos.dtype) for k, v in obs.items()}

    def state_spec(self):
        dev = self.device
        extras = {k: torch.zeros(1, *s, device=dev) for k, s in self._extras_spec().items()}
        state = {"qpos": self._qpos0[None], "qvel": torch.zeros(1, self.model.nv, device=dev),
                 "extras": extras}
        # Sorted by key, as the JAX env's spec comes out of ``eval_shape``.
        return {
            k: ArraySpec(np.float32, tuple(v.shape[1:]))
            for k, v in sorted(self.obs_fields(state).items())
        }

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (self.model.nu,), -1.0, 1.0)}

    def reset_env(self, draws):
        qpos, qvel, extras = self.init_state(draws)
        st = {"qpos": qpos, "qvel": qvel, "extras": extras}
        return st, self.obs_fields(st)

    def step_env(self, state, action, draws):
        action = action.reshape(-1, self.model.nu).to(torch.float32)
        qpos, qvel = self.physics_step(state, action)
        st = self.next_state(state, action, qpos, qvel)
        extras = st["extras"]
        obs = self.obs_fields(st)
        reward = self.reward_dmc(qpos, qvel, action, extras).to(torch.float32)
        term = self.terminated_dmc(qpos, qvel, extras)
        if term is None:
            terminated = torch.zeros(qpos.shape[0], dtype=torch.bool, device=qpos.device)
        else:
            terminated = term.to(torch.bool)
        # Time-limit-only tasks keep discount 1.0 when the episode ends; a
        # task that terminates ends with discount 0.
        discount = (~terminated).to(torch.float32)
        return EnvOut(st, obs, reward, terminated, discount=discount)
