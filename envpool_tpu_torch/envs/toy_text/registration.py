"""Toy-text registration: every id and alias of
``envpool_tpu/envs/toy_text/registration.py`` (reference
``envpool/toy_text/registration.py``), in its order."""

from ...core.registry import register

_PATH = "envpool_tpu_torch.envs.toy_text"

register(
    task_id="Catch-v0",
    import_path=_PATH,
    env_cls="CatchEnv",
    height=10,
    width=5,
)

register(
    task_id="FrozenLake-v1",
    import_path=_PATH,
    env_cls="FrozenLakeEnv",
    size=4,
    max_episode_steps=100,
    reward_threshold=0.7,
)

register(
    task_id="FrozenLake8x8-v1",
    import_path=_PATH,
    env_cls="FrozenLakeEnv",
    size=8,
    max_episode_steps=200,
    reward_threshold=0.85,
)

register(
    task_id="Taxi-v3",
    import_path=_PATH,
    env_cls="TaxiEnv",
    max_episode_steps=200,
    reward_threshold=8.0,
)

register(
    task_id="NChain-v0",
    import_path=_PATH,
    env_cls="NChainEnv",
    max_episode_steps=1000,
)

register(
    task_id="CliffWalking-v1",
    import_path=_PATH,
    env_cls="CliffWalkingEnv",
    aliases=["tabular/CliffWalking-v0"],
    is_slippery=False,
)

register(
    task_id="CliffWalkingSlippery-v1",
    import_path=_PATH,
    env_cls="CliffWalkingEnv",
    is_slippery=True,
)

register(
    task_id="CliffWalking-v0",
    import_path=_PATH,
    env_cls="CliffWalkingEnv",
    is_slippery=False,
)

register(
    task_id="Blackjack-v1",
    import_path=_PATH,
    env_cls="BlackjackEnv",
    aliases=["tabular/Blackjack-v0"],
    sab=True,
    natural=False,
)
