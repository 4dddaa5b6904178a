"""The port's Humanoid and HumanoidStandup against the JAX package.

The engine check of ``tests/test_torch_mujoco_gym_tasks.py`` (one step
from JAX's state within 1e-4 · (1 + |jax|), integer and bool fields equal,
across an auto-reset) on the v4 tasks and on Humanoid-v5, whose 348-dim
obs, healthy bonus and contact cost differ from v4.  Their JAX engines
take the longest to compile (about 25 s each on a CPU), so they have a
file of their own.
"""

import pytest

from test_torch_mujoco_gym_tasks import _JAX_DRAWS, check_step_matches_jax


@pytest.mark.parametrize(
    "task, draws",
    [
        ("Humanoid-v4", "Humanoid-v4"),
        ("Humanoid-v5", "Humanoid-v4"),
        ("HumanoidStandup-v4", "HumanoidStandup-v4"),
    ],
)
def test_step_matches_jax_across_auto_reset(task, draws):
    check_step_matches_jax(task, _JAX_DRAWS[draws])
