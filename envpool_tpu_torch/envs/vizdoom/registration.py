"""Vizdoom registration: the 21 ids of
``envpool_tpu/envs/vizdoom/registration.py`` (reference
``envpool/vizdoom/registration.py:24-50``): one ``{CamelCase}-v1`` id per
scenario, plus the ``VizdoomCustom-v1`` slot, each with
``max_episode_steps=525``."""

from ...core.registry import register
from .scenarios import SCENARIOS, camel

_PATH = "envpool_tpu_torch.envs.vizdoom"

for _name in sorted(SCENARIOS):
    register(
        task_id=f"{camel(_name)}-v1",
        import_path=_PATH,
        env_cls="DoomEnv",
        scenario=_name,
        max_episode_steps=525,
    )

# Custom slot: the basic arena unless a known scenario name is passed.
register(
    task_id="VizdoomCustom-v1",
    import_path=_PATH,
    env_cls="DoomEnv",
    scenario="basic",
    max_episode_steps=525,
)
