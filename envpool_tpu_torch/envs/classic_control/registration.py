"""Classic-control registration: every id and alias of
``envpool_tpu/envs/classic_control/registration.py``."""

from ...core.registry import register

_PATH = "envpool_tpu_torch.envs.classic_control"

register(
    task_id="CartPole-v0",
    import_path=_PATH,
    env_cls="CartPoleEnv",
    aliases=["phys2d/CartPole-v0"],
    max_episode_steps=200,
    reward_threshold=195.0,
)

register(
    task_id="CartPole-v1",
    import_path=_PATH,
    env_cls="CartPoleEnv",
    aliases=["phys2d/CartPole-v1"],
    max_episode_steps=500,
    reward_threshold=475.0,
)

register(
    task_id="Pendulum-v0",
    import_path=_PATH,
    env_cls="PendulumEnv",
    aliases=["phys2d/Pendulum-v0"],
    version=0,
    max_episode_steps=200,
)

register(
    task_id="Pendulum-v1",
    import_path=_PATH,
    env_cls="PendulumEnv",
    version=1,
    max_episode_steps=200,
)

register(
    task_id="MountainCar-v0",
    import_path=_PATH,
    env_cls="MountainCarEnv",
    max_episode_steps=200,
)

register(
    task_id="MountainCarContinuous-v0",
    import_path=_PATH,
    env_cls="MountainCarContinuousEnv",
    max_episode_steps=999,
)

register(
    task_id="Acrobot-v1",
    import_path=_PATH,
    env_cls="AcrobotEnv",
    max_episode_steps=500,
)
