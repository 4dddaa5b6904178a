"""MetaWorld registration: the 50 ids of
``envpool_tpu/envs/metaworld/registration.py`` (reference
``envpool/mujoco/metaworld/registration.py``), in its order, with EnvPool's
public ``MetaWorld/{CamelCase}-v3`` names."""

from ...core.registry import register
from .tasks import TASKS

_PATH = "envpool_tpu_torch.envs.metaworld"


def _public_name(task_name: str) -> str:
    name, version = task_name.rsplit("-", 1)
    camel = "".join(p[:1].upper() + p[1:] for p in name.split("-"))
    return f"MetaWorld/{camel}-{version}"


for _task in TASKS:
    register(
        task_id=_public_name(_task),
        import_path=_PATH,
        env_cls="SawyerEnv",
        task_name=_task,
        max_episode_steps=500,
    )
