"""Atari-class pixel-env registration (the slice ported so far).

Counterpart of ``envpool_tpu/envs/atari/registration.py``; only the
``PongLite-v5`` entry is ported.
"""

from ...core.registry import register

_PATH = "envpool_tpu_torch.envs.atari"

register(
    task_id="PongLite-v5",
    import_path=_PATH,
    env_cls="PongEnv",
    max_episode_steps=27000,
    task="pong",
)
