"""Import all env family registrations of the port."""

import envpool_tpu_torch.envs.atari.registration  # noqa: F401
