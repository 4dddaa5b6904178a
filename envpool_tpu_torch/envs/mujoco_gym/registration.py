"""Gym-MuJoCo registration: every id of
``envpool_tpu/envs/mujoco_gym/registration.py``, with the same per-version
config (reference ``envpool/mujoco/gym/registration.py:20-95``): v4
semantics, and the v5 reward, observation and model toggles."""

from typing import Any

from ...core.registry import register

_PATH = "envpool_tpu_torch.envs.mujoco_gym"

_TASKS = [
    ("Ant", "AntEnv", ("v3", "v4", "v5"), 1000),
    ("HalfCheetah", "HalfCheetahEnv", ("v3", "v4", "v5"), 1000),
    ("Hopper", "HopperEnv", ("v3", "v4", "v5"), 1000),
    ("Humanoid", "HumanoidEnv", ("v3", "v4", "v5"), 1000),
    ("HumanoidStandup", "HumanoidStandupEnv", ("v2", "v4", "v5"), 1000),
    ("InvertedDoublePendulum", "InvertedDoublePendulumEnv",
     ("v2", "v4", "v5"), 1000),
    ("InvertedPendulum", "InvertedPendulumEnv", ("v2", "v4", "v5"), 1000),
    ("Pusher", "PusherEnv", ("v2", "v4", "v5"), 100),
    ("Reacher", "ReacherEnv", ("v2", "v4", "v5"), 50),
    ("Swimmer", "SwimmerEnv", ("v3", "v4", "v5"), 1000),
    ("Walker2d", "Walker2dEnv", ("v3", "v4", "v5"), 1000),
]


def _v5_extras(task: str) -> dict[str, Any]:
    extra: dict[str, Any] = {}
    if task in ("InvertedPendulum", "InvertedDoublePendulum"):
        extra["reward_if_not_terminated"] = True
    if task in ("Reacher", "Pusher"):
        extra["reward_after_step"] = True
    if task == "Reacher":
        extra["v5_obs"] = True
    if task in ("Hopper", "Walker2d", "Ant"):
        extra["legacy_healthy_reward"] = False
    if task == "Pusher":
        extra["xml_file"] = "pusher_v5.xml"
    if task == "Humanoid":
        extra["legacy_healthy_reward"] = False
        extra["contact_cost_weight"] = 5e-7
        extra["v5_obs"] = True
    if task == "HumanoidStandup":
        extra["v5_obs"] = True
    return extra


for _task, _cls, _versions, _steps in _TASKS:
    for _version in _versions:
        register(
            task_id=f"{_task}-{_version}",
            import_path=_PATH,
            env_cls=_cls,
            max_episode_steps=_steps,
            **(_v5_extras(_task) if _version == "v5" else {}),
        )
