"""The batched env engine with fused auto-reset, in PyTorch.

Counterpart of ``envpool_tpu/core/engine.py``.  Env state is a dict of
``[num_envs, ...]`` tensors on one device.  One step runs the env's
batched reset branch and step branch over every row and selects between
them with ``torch.where`` (the JAX engine does the same under ``vmap``), so
auto-reset needs no host synchronisation.

Common-field bookkeeping (``elapsed_step``, ``done``, ``trunc``,
``discount``, ``step_type``, ``info:env_id``) follows ``Env::Allocate``
(``envpool/core/env.h:224-256``) and the JAX engine bit for bit:

* ``done = terminated || elapsed >= max_episode_steps`` (set on the step)
* ``trunc = done && elapsed >= max_episode_steps``
* ``discount = float(!done)`` unless the env overrides it
* ``step_type``: 0 (FIRST) on reset, 2 (LAST) when done, else 1 (MID)

The env's branches run their float32 matmuls without TF32 whatever the
caller set (:func:`full_fp32`): the JAX package computes them in full
float32, and a success threshold of 1 cm sits within TF32's error of a
forward kinematics pass.

Every function returns new tensors and never writes into its input state:
timesteps still queued in an adapter may be views of an earlier state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..ops.batched import full_fp32
from . import rng
from .env import TorchEnv, tree_where

__all__ = ["PoolState", "Engine", "TimeStepDict"]

# A flat {key: batched tensor} timestep, common fields + env state fields.
TimeStepDict = dict[str, torch.Tensor]


@dataclasses.dataclass
class PoolState:
    """Device-resident state of the whole pool."""

    env_state: Any            # env-specific dict of [N, ...] tensors
    key: torch.Tensor         # [N, 2] int64 random-stream keys
    elapsed: torch.Tensor     # [N] int32, steps since episode start
    autoreset: torch.Tensor   # [N] bool: episode over, reset on next step
    full_reset: torch.Tensor  # [N] bool: pending reset must fully restart

    @property
    def num_envs(self) -> int:
        return self.elapsed.shape[0]


def _tree_map(fn: Callable, *trees: Any) -> Any:
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Engine:
    """Owns the pool-level step/reset functions for one env.

    All public functions are pure: ``(PoolState, ...) -> (PoolState, ts)``.
    """

    def __init__(self, env: TorchEnv):
        self.env = env
        self.num_envs = env.num_envs
        self.device = env.device

    # -- construction ------------------------------------------------------

    def init(self) -> PoolState:
        """Initial pool state: every env 'done', pending its first reset.

        The env state is zero-filled with the shapes and dtypes of a one-row
        reset (the counterpart of the JAX engine's ``eval_shape``).
        """
        n = self.num_envs
        keys = self.env.keys()
        probe = self._reset_rows(keys[:1])[0]
        env_state = _tree_map(
            lambda t: torch.zeros(
                (n, *t.shape[1:]), dtype=t.dtype, device=self.device
            ),
            probe,
        )
        return PoolState(
            env_state=env_state,
            key=keys,
            elapsed=torch.zeros(n, dtype=torch.int32, device=self.device),
            autoreset=torch.ones(n, dtype=torch.bool, device=self.device),
            full_reset=torch.ones(n, dtype=torch.bool, device=self.device),
        )

    # -- batched kernels ---------------------------------------------------

    def _reset_rows(self, key: torch.Tensor):
        key, sub = rng.split(key)
        with full_fp32():
            state, obs = self.env.reset_env(self.env.reset_draws(sub))
        return state, key, obs

    def _step_rows(self, env_state, key, elapsed, do_reset, full_reset, action):
        """Batched transition with fused auto-reset (both branches + select)."""
        env = self.env
        key, sub = rng.split(key)
        with full_fp32():
            # Reset branch (sees the terminal state for continuation
            # semantics).
            r_state, r_obs = env.reset_env_from(
                env_state, env.reset_draws(sub), full_reset
            )
            # Step branch.
            out = env.step_env(
                env_state, env.single_action(action), env.step_draws(sub)
            )
        new_elapsed = torch.where(do_reset, 0, elapsed + 1).to(torch.int32)
        time_trunc = new_elapsed >= env.max_episode_steps
        if out.truncated is not None:
            trunc_cond = time_trunc | out.truncated
        else:
            trunc_cond = time_trunc
        done_step = out.terminated | trunc_cond
        done = torch.where(do_reset, False, done_step)
        trunc = done & trunc_cond
        # (a multi-player game's reward has one row per player)
        reward = tree_where(
            do_reset, torch.zeros_like(out.reward), out.reward
        ).to(torch.float32)
        if out.discount is not None:
            discount_step = out.discount.to(torch.float32)
        else:
            discount_step = 1.0 - done_step.to(torch.float32)
        discount = torch.where(do_reset, 1.0, discount_step)
        step_type = torch.where(
            do_reset, 0, torch.where(done, 2, 1)
        ).to(torch.int32)
        new_state = tree_where(do_reset, r_state, out.state)
        obs = tree_where(do_reset, r_obs, out.obs)
        common = {
            "elapsed_step": new_elapsed,
            "done": done,
            "reward": reward,
            "discount": discount,
            "step_type": step_type,
            "trunc": trunc,
        }
        return new_state, key, new_elapsed, done, obs, common

    # -- batched pool functions --------------------------------------------

    def _finish_ts(
        self, obs: dict, common: dict, env_id: torch.Tensor
    ) -> TimeStepDict:
        players = self.env.max_num_players
        env_id = env_id.to(torch.int32)
        players_env_id = (
            env_id[:, None].expand(env_id.shape[0], players)
            if players > 1
            else env_id
        )
        ts: TimeStepDict = {
            "info:env_id": env_id,
            "info:players.env_id": players_env_id,
        }
        ts.update(common)
        ts.update(obs)
        # The JAX engine's timesteps come out of jit with sorted keys, and
        # the adapters' field order follows it.
        return dict(sorted(ts.items()))

    def _arange(self) -> torch.Tensor:
        return torch.arange(self.num_envs, dtype=torch.int32, device=self.device)

    def step(
        self,
        ps: PoolState,
        action: dict[str, torch.Tensor],
        force_reset: torch.Tensor | None = None,
    ) -> tuple[PoolState, TimeStepDict]:
        """Full-batch lockstep step (sync mode, ``batch_size == num_envs``)."""
        do_reset = ps.autoreset
        full = ps.full_reset
        if force_reset is not None:
            do_reset = do_reset | force_reset
            full = full | force_reset
        new_state, key, elapsed, done, obs, common = self._step_rows(
            ps.env_state, ps.key, ps.elapsed, do_reset, full, action
        )
        new_ps = PoolState(new_state, key, elapsed, done, common["trunc"])
        return new_ps, self._finish_ts(obs, common, self._arange())

    def reset(
        self, ps: PoolState, mask: torch.Tensor
    ) -> tuple[PoolState, TimeStepDict]:
        """Force-reset the masked envs; others are untouched (state & RNG).

        Rows outside the mask carry placeholder values — adapters gather
        only masked rows.
        """
        r_state, r_key, r_obs = self._reset_rows(ps.key)
        new_ps = PoolState(
            env_state=tree_where(mask, r_state, ps.env_state),
            key=tree_where(mask, r_key, ps.key),
            elapsed=torch.where(mask, 0, ps.elapsed).to(torch.int32),
            autoreset=torch.where(mask, False, ps.autoreset),
            full_reset=torch.where(mask, False, ps.full_reset),
        )
        common = self._reset_common(self.num_envs)
        return new_ps, self._finish_ts(r_obs, common, self._arange())

    def _reset_common(self, n: int) -> dict[str, torch.Tensor]:
        dev = self.device
        zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
        return {
            "elapsed_step": zeros_i,
            "done": torch.zeros(n, dtype=torch.bool, device=dev),
            "reward": torch.zeros(n, dtype=torch.float32, device=dev),
            "discount": torch.ones(n, dtype=torch.float32, device=dev),
            "step_type": zeros_i,  # StepType.FIRST
            "trunc": torch.zeros(n, dtype=torch.bool, device=dev),
        }

    def reset_partial(
        self, ps: PoolState, env_id: torch.Tensor
    ) -> tuple[PoolState, TimeStepDict]:
        """Force-reset only ``env_id`` rows (gather/reset/scatter)."""
        env_id = env_id.to(device=self.device, dtype=torch.int64)
        r_state, r_key, r_obs = self._reset_rows(ps.key.index_select(0, env_id))
        common = self._reset_common(env_id.shape[0])

        def scatter(buf, rows):
            return buf.index_copy(0, env_id, rows)

        new_ps = PoolState(
            env_state=_tree_map(scatter, ps.env_state, r_state),
            key=scatter(ps.key, r_key),
            elapsed=scatter(ps.elapsed, common["elapsed_step"]),
            autoreset=scatter(ps.autoreset, common["done"]),
            full_reset=scatter(ps.full_reset, common["trunc"]),
        )
        return new_ps, self._finish_ts(r_obs, common, env_id)

    def step_partial(
        self,
        ps: PoolState,
        action: dict[str, torch.Tensor],
        env_id: torch.Tensor,
    ) -> tuple[PoolState, TimeStepDict]:
        """Step only ``env_id`` rows (async mode, ``batch_size < num_envs``)."""
        env_id = env_id.to(device=self.device, dtype=torch.int64)

        def take(t):
            return t.index_select(0, env_id)

        new_state, key, elapsed, done, obs, common = self._step_rows(
            _tree_map(take, ps.env_state),
            take(ps.key),
            take(ps.elapsed),
            take(ps.autoreset),
            take(ps.full_reset),
            action,
        )

        def scatter(buf, rows):
            return buf.index_copy(0, env_id, rows)

        new_ps = PoolState(
            env_state=_tree_map(scatter, ps.env_state, new_state),
            key=scatter(ps.key, key),
            elapsed=scatter(ps.elapsed, elapsed),
            autoreset=scatter(ps.autoreset, done),
            full_reset=scatter(ps.full_reset, common["trunc"]),
        )
        return new_ps, self._finish_ts(obs, common, env_id)

    # -- rollout -----------------------------------------------------------

    def zero_action(self) -> dict[str, torch.Tensor]:
        """Batched all-zeros action tree (used to bootstrap rollouts)."""
        env = self.env
        return {
            k: torch.zeros(
                (env.num_envs, *s.static_shape(env.max_num_players)),
                dtype=s.torch_dtype,
                device=self.device,
            )
            for k, s in env.action_spec().items()
        }

    def make_rollout(
        self,
        policy: Callable[[TimeStepDict, torch.Generator], dict[str, torch.Tensor]],
        num_steps: int,
        reset_first: bool = True,
        collect: bool = True,
    ) -> Callable[[PoolState, int], tuple[PoolState, Any]]:
        """A T-step rollout ``run(ps, policy_seed) -> (ps, traj)``.

        Counterpart of the JAX engine's ``lax.scan`` rollout.  ``policy``
        maps ``(timestep, generator) -> action tree``; the generator lives
        on the pool's device and is seeded with ``policy_seed``.  With
        ``collect=False`` only the last timestep is returned.
        """

        def run(ps: PoolState, policy_seed: int):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(policy_seed))
            if reset_first:
                ps, ts = self.reset(
                    ps, torch.ones(self.num_envs, dtype=torch.bool, device=self.device)
                )
            else:
                ps, ts = self.step(ps, self.zero_action())
            traj = []
            for _ in range(num_steps):
                ps, ts = self.step(ps, policy(ts, gen))
                if collect:
                    traj.append(ts)
            if not collect:
                return ps, ts
            return ps, {k: torch.stack([t[k] for t in traj]) for k in ts}

        return run
