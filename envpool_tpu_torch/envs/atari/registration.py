"""Atari-class pixel-env registration (the slices ported so far).

Counterpart of ``envpool_tpu/envs/atari/registration.py``: ``PongLite-v5``,
``Machine2600-v0`` and the twelve ``Machine2600/{Game}-v5`` preset ids.
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

# The 2600 machine env: runs a user-supplied cartridge ROM on the 6502+TIA
# emulator behind the standard pipeline (rom_path is required at make()).
register(
    task_id="Machine2600-v0",
    import_path=_PATH,
    env_cls="Machine2600Env",
    max_episode_steps=27000,
    task="machine2600",
)

# Per-ROM preset ids (rom_presets.py): ALE-style reward/lives/terminal
# semantics and minimal action sets for the matching cartridge dump.
for _preset, _name in (
    ("breakout", "Breakout"),
    ("pong", "Pong"),
    ("freeway", "Freeway"),
    ("space_invaders", "SpaceInvaders"),
    ("seaquest", "Seaquest"),
    ("boxing", "Boxing"),
    ("asteroids", "Asteroids"),
    ("ms_pacman", "MsPacman"),
    ("qbert", "Qbert"),
    ("bowling", "Bowling"),
    ("frostbite", "Frostbite"),
    ("battle_zone", "BattleZone"),
):
    register(
        task_id=f"Machine2600/{_name}-v5",
        import_path=_PATH,
        env_cls="Machine2600Env",
        max_episode_steps=27000,
        task="machine2600",
        game=_preset,
    )
