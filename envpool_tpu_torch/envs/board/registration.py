"""Board-game registration: every id of
``envpool_tpu/envs/board/registration.py`` (reference
``envpool/pgx/registration.py``), in its order, with its configs."""

from ...core.registry import register

_PATH = "envpool_tpu_torch.envs.board"

register(task_id="Play2048-v1", import_path=_PATH, env_cls="Game2048Env")
register(task_id="TicTacToe-v1", import_path=_PATH, env_cls="TicTacToeEnv")
register(task_id="ConnectFour-v1", import_path=_PATH, env_cls="Connect4Env")
register(task_id="Othello-v1", import_path=_PATH, env_cls="OthelloEnv")
register(task_id="KuhnPoker-v1", import_path=_PATH, env_cls="KuhnPokerEnv")
register(task_id="LeducHoldem-v1", import_path=_PATH, env_cls="LeducHoldemEnv")
register(task_id="Hex-v1", import_path=_PATH, env_cls="HexEnv")
register(
    task_id="Backgammon-v1",
    import_path=_PATH,
    env_cls="BackgammonEnv",
)
register(
    task_id="AnimalShogi-v1",
    import_path=_PATH,
    env_cls="AnimalShogiEnv",
)
register(
    task_id="Chess-v1",
    import_path=_PATH,
    env_cls="ChessEnv",
)
register(
    task_id="GardnerChess-v1",
    import_path=_PATH,
    env_cls="GardnerChessEnv",
)
register(
    task_id="Shogi-v1",
    import_path=_PATH,
    env_cls="ShogiEnv",
)
register(
    task_id="SparrowMahjong-v1",
    import_path=_PATH,
    env_cls="SparrowMahjongEnv",
    max_num_players=3,
)

# Go family (reference ids: envpool/pgx/registration.py:32-74).
for _size in (9, 13, 19):
    register(
        task_id=f"Go{_size}x{_size}-v1",
        import_path=_PATH,
        env_cls="GoEnv",
        board_size=_size,
        komi=7.5,
        rules="pgx",
    )
    register(
        task_id=f"ChineseGo{_size}x{_size}-v1",
        import_path=_PATH,
        env_cls="GoEnv",
        board_size=_size,
        komi=7.5,
        rules="chinese",
    )
