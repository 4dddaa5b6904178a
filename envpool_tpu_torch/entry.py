"""Import all env family registrations of the port (in the JAX package's
order, so that ``list_all_envs`` lists the ids as it does)."""

import envpool_tpu_torch.envs.atari.registration  # noqa: F401
import envpool_tpu_torch.envs.board.registration  # noqa: F401
import envpool_tpu_torch.envs.classic_control.registration  # noqa: F401
import envpool_tpu_torch.envs.highway.registration  # noqa: F401
import envpool_tpu_torch.envs.metaworld.registration  # noqa: F401
import envpool_tpu_torch.envs.minigrid.registration  # noqa: F401
import envpool_tpu_torch.envs.mujoco_dmc.registration  # noqa: F401
import envpool_tpu_torch.envs.mujoco_gym.registration  # noqa: F401
import envpool_tpu_torch.envs.procgen.registration  # noqa: F401
import envpool_tpu_torch.envs.robotics.registration  # noqa: F401
import envpool_tpu_torch.envs.toy_text.registration  # noqa: F401
import envpool_tpu_torch.envs.vizdoom.registration  # noqa: F401
from envpool_tpu_torch.core.registry import register as _register

_register(
    task_id="Dummy-v0",
    import_path="envpool_tpu_torch.envs.dummy",
    env_cls="DummyEnv",
)
