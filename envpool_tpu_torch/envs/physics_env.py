"""What the env families over the port's rigid-body physics share.

``envs/mujoco_gym`` and ``envs/mujoco_dmc`` both hold a state dict with
``qpos`` ``[N, nq]`` and ``qvel`` ``[N, nv]`` and advance it by
``frame_skip`` model timesteps of ``substeps`` each per env step.  The
hooks here are what a caller needs to hold one step of such an env to a
reference (``chip_smoke.py`` steps the card, the CPU and float64): the
physics step alone, the observations of a state, and how far a state lies
from a termination bound.
"""

from __future__ import annotations

import torch

from ..core.env import TorchEnv
from ..physics.dynamics import step as phys_step


class PhysicsEnv(TorchEnv):
    """Base of the envs that step ``self.model`` with the port's physics.

    A subclass sets ``model``, ``contact``, ``substeps`` and
    ``frame_skip`` in its ``__init__``.
    """

    # The dtype the physics steps in; None: the state's own.  The state
    # stays float32 either way, so a float64 step is rounded once, at its
    # end (``DmcEnv`` sets it for a model float32 cannot step within the
    # one-step bar).
    physics_dtype: torch.dtype | None = None

    def control(self, state, action: torch.Tensor) -> torch.Tensor:
        """The ``[N, nu]`` control the physics applies for ``action``."""
        del state
        return action

    def physics_step(self, state, action: torch.Tensor):
        """``(qpos, qvel)`` after one env step of ``state`` under ``action``,
        in the dtype and on the device of ``state``."""
        q = state["qpos"]
        dtype = torch.promote_types(q.dtype, self.physics_dtype or q.dtype)
        qpos, qvel = phys_step(
            self.model, q.to(dtype), state["qvel"].to(dtype),
            self.control(state, action).to(dtype), self.substeps, self.contact,
            self.frame_skip,
        )
        return qpos.to(q.dtype), qvel.to(q.dtype)

    def next_state(self, state, action: torch.Tensor, qpos: torch.Tensor,
                   qvel: torch.Tensor):
        """The env state after one env step of ``state`` under ``action``
        whose physics ended in ``(qpos, qvel)``: ``state`` with the new
        coordinates, unless the task carries more state across a step
        (quadruped's actuator activations)."""
        del action
        return dict(state, qpos=qpos, qvel=qvel)

    def obs_fields(self, state) -> dict[str, torch.Tensor]:
        """The observation fields of ``state``, keyed as in the timestep."""
        raise NotImplementedError

    def termination_margin(self, state) -> torch.Tensor:
        """``[N]`` distance of each state to the bound on which the task
        terminates, where the task compares a quantity computed from the
        state (two devices may round it to either side).  Infinite where it
        compares the state's own coordinates, which read the same
        everywhere, or never terminates."""
        return state["qpos"].new_full((state["qpos"].shape[0],), float("inf"))
