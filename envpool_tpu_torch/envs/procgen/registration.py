"""Procgen registration: the 50 ids of
``envpool_tpu/envs/procgen/registration.py`` (reference
``envpool/procgen/registration.py``), in its order."""

from ...core.registry import register

_PATH = "envpool_tpu_torch.envs.procgen"

# game → distribution modes registered by the reference.
_IDS = {
    "bigfish": ("Easy", "Hard"),
    "bossfight": ("Easy", "Hard"),
    "caveflyer": ("Easy", "Exploration", "Hard", "Memory"),
    "chaser": ("Easy", "Hard", "Extreme"),
    "climber": ("Easy", "Exploration", "Hard"),
    "coinrun": ("Easy", "Exploration", "Hard"),
    "dodgeball": ("Easy", "Hard", "Extreme", "Memory"),
    "fruitbot": ("Easy", "Hard"),
    "heist": ("Easy", "Exploration", "Hard", "Memory"),
    "jumper": ("Easy", "Exploration", "Hard", "Memory"),
    "leaper": ("Easy", "Exploration", "Hard", "Extreme"),
    "maze": ("Easy", "Exploration", "Hard", "Memory"),
    "miner": ("Easy", "Hard", "Memory"),
    "ninja": ("Easy", "Exploration", "Hard"),
    "plunder": ("Easy", "Hard"),
    "starpilot": ("Easy", "Hard", "Extreme"),
}

for _game, _modes in _IDS.items():
    for _mode in _modes:
        register(
            task_id=f"{_game.capitalize()}{_mode}-v0",
            import_path=_PATH,
            env_cls="ProcgenEnv",
            env_name=_game,
            distribution_mode=_mode.lower(),
            max_episode_steps=1000,
        )
