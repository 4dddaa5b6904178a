"""Gym-MuJoCo registration of the ported tasks: ``HalfCheetah-v3/v4/v5``
(``envpool_tpu/envs/mujoco_gym/registration.py`` registers the others)."""

from ...core.registry import register

_PATH = "envpool_tpu_torch.envs.mujoco_gym"

for _version in ("v3", "v4", "v5"):
    register(
        task_id=f"HalfCheetah-{_version}",
        import_path=_PATH,
        env_cls="HalfCheetahEnv",
        max_episode_steps=1000,
    )
