"""The port's manipulator and stacker against the JAX package.

One engine step across an auto-reset of ManipulatorBringBall and
StackerStack2 from JAX's states with JAX's reset draws, held by
``test_torch_mujoco_dmc_suite2.check_stiff_step`` (1e-4 · (1 + |jax|), or
float32 at fault as a float64 step shows; the reference's physics diverges
on some of their start states, and the port's with it).  The other
manipulator variants differ in their model, start, obs and reward: those
run from JAX's draws and states against JAX's own functions (their pair
forces are in ``test_torch_mujoco_dmc_forces.py``; ManipulatorInsertPeg's
and StackerStack4's start, obs and reward in
``test_torch_mujoco_dmc_suite2.py``).
"""

import pytest

from test_torch_mujoco_dmc_suite2 import check_start_obs_and_reward, check_stiff_step


@pytest.mark.parametrize("task", ["ManipulatorBringBall-v1", "StackerStack2-v1"])
def test_step_matches_jax_across_auto_reset(task):
    check_stiff_step(task)


@pytest.mark.parametrize(
    "task", ["ManipulatorBringPeg-v1", "ManipulatorInsertBall-v1"])
def test_start_obs_and_reward_match_jax(task):
    check_start_obs_and_reward(task)
