"""The port's QuadrupedFetch-v1 against the JAX package: the quadruped
with body-body contact pairs (124) and a second free joint (the ball).

Its pairs' forces, their normal forces and one Euler substep, on JAX's
start states moved to the origin at ``qpos0``'s height with the ball put
on the quadruped's legs (``test_torch_mujoco_dmc_forces.check_pair_forces``: 2e-5 · (1 +
|jax|) for the forces, 1e-4 · (1 + |jax|) for the substep); the switches
of its pairs; and its start, obs and reward from JAX's draws and states
against JAX's own functions.
"""

from test_torch_mujoco_dmc_forces import check_pair_forces, check_pair_switches
from test_torch_mujoco_dmc_suite2 import check_start_obs_and_reward

TASK = "QuadrupedFetch-v1"


def test_pair_forces_and_one_euler_substep():
    check_pair_forces(TASK, step=True)


def test_pair_switches():
    check_pair_switches(TASK)


def test_start_obs_and_reward_match_jax():
    check_start_obs_and_reward(TASK)
