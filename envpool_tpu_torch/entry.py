"""Import all env family registrations of the port."""

import envpool_tpu_torch.envs.atari.registration  # noqa: F401
import envpool_tpu_torch.envs.classic_control.registration  # noqa: F401
import envpool_tpu_torch.envs.mujoco_gym.registration  # noqa: F401
