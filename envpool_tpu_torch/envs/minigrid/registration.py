"""MiniGrid and BabyAI registration: the 177 ids of
``envpool_tpu/envs/minigrid/registration.py`` (reference
``envpool/minigrid/registration.py``), in its order, with the same
``max_episode_steps`` and config."""

from ...core.registry import register

_PATH = "envpool_tpu_torch.envs.minigrid"


def _reg(task_id: str, max_episode_steps: int, **kwargs) -> None:
    register(
        task_id=task_id,
        import_path=_PATH,
        env_cls="MiniGridEnv",
        max_episode_steps=max_episode_steps,
        **kwargs,
    )


for size in (5, 6, 8, 16):
    _reg(
        f"MiniGrid-Empty-{size}x{size}-v0",
        4 * size * size,
        env_name="empty",
        size=size,
    )
for size in (5, 6):
    _reg(
        f"MiniGrid-Empty-Random-{size}x{size}-v0",
        4 * size * size,
        env_name="empty",
        size=size,
        random_start=True,
    )
for size in (5, 6, 8, 16):
    _reg(
        f"MiniGrid-DoorKey-{size}x{size}-v0",
        10 * size * size,
        env_name="doorkey",
        size=size,
    )
_reg("MiniGrid-FourRooms-v0", 100, env_name="fourrooms", size=19)
for size in (5, 6, 7):
    _reg(
        f"MiniGrid-LavaGapS{size}-v0",
        4 * size * size,
        env_name="lavagap",
        size=size,
    )
_reg(
    "MiniGrid-DistShift1-v0",
    4 * 81,
    env_name="distshift",
    width=9,
    height=7,
    strip2_row=2,
)
_reg(
    "MiniGrid-DistShift2-v0",
    4 * 81,
    env_name="distshift",
    width=9,
    height=7,
    strip2_row=5,
)
for n in (1, 2, 3):
    _reg(
        f"MiniGrid-SimpleCrossingS9N{n}-v0",
        4 * 81,
        env_name="crossing",
        size=9,
        num_crossings=n,
        obstacle_type="wall",
    )
    _reg(
        f"MiniGrid-LavaCrossingS9N{n}-v0",
        4 * 81,
        env_name="crossing",
        size=9,
        num_crossings=n,
        obstacle_type="lava",
    )

register(
    task_id="BabyAI-GoToObj-v0",
    import_path=_PATH,
    env_cls="BabyAIGoToEnv",
    env_name="goto_obj",
    size=8,
    max_episode_steps=64,
)
register(
    task_id="BabyAI-GoToDoor-v0",
    import_path=_PATH,
    env_cls="BabyAIGoToEnv",
    env_name="goto_door",
    size=8,
    max_episode_steps=256,
)

# --- wave 2 (tasks2.py) ----------------------------------------------------

for n in (5,):
    _reg(
        "MiniGrid-SimpleCrossingS11N5-v0",
        4 * 121,
        env_name="crossing",
        size=11,
        num_crossings=n,
        obstacle_type="wall",
    )
    _reg(
        "MiniGrid-LavaCrossingS11N5-v0",
        4 * 121,
        env_name="crossing",
        size=11,
        num_crossings=n,
        obstacle_type="lava",
    )

for task_id, size, n_obstacles, random_start in (
    ("MiniGrid-Dynamic-Obstacles-5x5-v0", 5, 2, False),
    ("MiniGrid-Dynamic-Obstacles-Random-5x5-v0", 5, 2, True),
    ("MiniGrid-Dynamic-Obstacles-6x6-v0", 6, 3, False),
    ("MiniGrid-Dynamic-Obstacles-Random-6x6-v0", 6, 3, True),
    ("MiniGrid-Dynamic-Obstacles-8x8-v0", 8, 4, False),
    ("MiniGrid-Dynamic-Obstacles-16x16-v0", 16, 8, False),
):
    register(
        task_id=task_id,
        import_path=_PATH,
        env_cls="DynamicObstaclesEnv",
        max_episode_steps=4 * size * size,
        size=size,
        n_obstacles=n_obstacles,
        random_start=random_start,
    )

for task_id, size, num_objs in (
    ("MiniGrid-Fetch-5x5-N2-v0", 5, 2),
    ("MiniGrid-Fetch-6x6-N2-v0", 6, 2),
    ("MiniGrid-Fetch-8x8-N3-v0", 8, 3),
):
    register(
        task_id=task_id,
        import_path=_PATH,
        env_cls="FetchEnv",
        max_episode_steps=5 * size * size,
        size=size,
        num_objs=num_objs,
    )

for size in (5, 6, 8):
    register(
        task_id=f"MiniGrid-GoToDoor-{size}x{size}-v0",
        import_path=_PATH,
        env_cls="GoToEnv",
        env_name="goto_door",
        max_episode_steps=4 * size * size,
        size=size,
    )

for task_id, size, num_objs in (
    ("MiniGrid-GoToObject-6x6-N2-v0", 6, 2),
    ("MiniGrid-GoToObject-8x8-N2-v0", 8, 2),
):
    register(
        task_id=task_id,
        import_path=_PATH,
        env_cls="GoToEnv",
        env_name="goto_object",
        max_episode_steps=5 * size * size,
        size=size,
        num_objs=num_objs,
    )

for size in (6, 8):
    register(
        task_id=f"MiniGrid-RedBlueDoors-{size}x{size}-v0",
        import_path=_PATH,
        env_cls="RedBlueDoorsEnv",
        max_episode_steps=20 * size * size,
        size=size,
    )

register(
    task_id="MiniGrid-Unlock-v0",
    import_path=_PATH,
    env_cls="UnlockEnv",
    env_name="unlock",
    max_episode_steps=8 * 36,
)
register(
    task_id="MiniGrid-UnlockPickup-v0",
    import_path=_PATH,
    env_cls="UnlockEnv",
    env_name="unlock_pickup",
    max_episode_steps=8 * 36,
)

for task_id, size, random_length in (
    ("MiniGrid-MemoryS17Random-v0", 17, True),
    ("MiniGrid-MemoryS13Random-v0", 13, True),
    ("MiniGrid-MemoryS13-v0", 13, False),
    ("MiniGrid-MemoryS11-v0", 11, False),
    ("MiniGrid-MemoryS9-v0", 9, False),
    ("MiniGrid-MemoryS7-v0", 7, False),
):
    register(
        task_id=task_id,
        import_path=_PATH,
        env_cls="MemoryEnv",
        max_episode_steps=5 * size * size,
        size=size,
        random_length=random_length,
    )

# --- BabyAI wave 2 (desc-matched GoTo levels) -------------------------------

def _reg_babyai(task_id, size=8, num_dists=7, **kwargs):
    register(
        task_id=task_id,
        import_path=_PATH,
        env_cls="BabyAILocalEnv",
        max_episode_steps=8 * size * size,
        size=size,
        num_dists=num_dists,
        **kwargs,
    )


_reg_babyai("BabyAI-GoToRedBall-v0", env_name="goto_red_ball")
_reg_babyai("BabyAI-GoToRedBallGrey-v0", env_name="goto_red_ball_grey")
_reg_babyai(
    "BabyAI-GoToRedBallNoDists-v0", env_name="goto_red_ball", num_dists=0
)
_reg_babyai("BabyAI-GoToRedBlueBall-v0", env_name="goto_red_blue_ball")

for task_id, num_dists, size in (
    ("BabyAI-GoToLocal-v0", 8, 8),
    ("BabyAI-GoToLocalS5N2-v0", 2, 5),
    ("BabyAI-GoToLocalS6N2-v0", 2, 6),
    ("BabyAI-GoToLocalS6N3-v0", 3, 6),
    ("BabyAI-GoToLocalS6N4-v0", 4, 6),
    ("BabyAI-GoToLocalS7N4-v0", 4, 7),
    ("BabyAI-GoToLocalS7N5-v0", 5, 7),
    ("BabyAI-GoToLocalS8N2-v0", 2, 8),
    ("BabyAI-GoToLocalS8N3-v0", 3, 8),
    ("BabyAI-GoToLocalS8N4-v0", 4, 8),
    ("BabyAI-GoToLocalS8N5-v0", 5, 8),
    ("BabyAI-GoToLocalS8N6-v0", 6, 8),
    ("BabyAI-GoToLocalS8N7-v0", 7, 8),
):
    _reg_babyai(task_id, size=size, num_dists=num_dists, env_name="goto_local")

for task_id, size in (
    ("BabyAI-GoToObjS4-v0", 4),
    ("BabyAI-GoToObjS6-v1", 6),
):
    register(
        task_id=task_id,
        import_path=_PATH,
        env_cls="BabyAIGoToEnv",
        env_name="goto_obj",
        size=size,
        max_episode_steps=8 * size * size,
    )

# ---------------------------------------------------------------------------
# RoomGrid wave: the remaining BabyAI level suite + multi-room MiniGrid
# tasks (see roomgrid.py for documented generation deviations).
# ---------------------------------------------------------------------------


def _rg(task_id, env_cls, steps, **kwargs):
    register(
        task_id=task_id,
        import_path=_PATH,
        env_cls=env_cls,
        max_episode_steps=steps,
        **kwargs,
    )


# BabyAI one-room and find levels.
for s in (8, 12, 16, 20):
    _rg(f"BabyAI-OneRoomS{s}-v0", "OneRoomEnv", 8 * s * s,
        room_size=s, num_rows=1, num_cols=1, num_dists=0)
for s in (5, 6, 7):
    _rg(f"BabyAI-FindObjS{s}-v0", "FindObjEnv", 8 * s * s * 9,
        room_size=s, num_rows=3, num_cols=3, num_dists=0)

# BabyAI GoTo maze family.
_rg("BabyAI-GoTo-v0", "GoToMazeEnv", 8 * 64 * 9, num_dists=18)
_rg("BabyAI-GoToOpen-v0", "GoToMazeEnv", 8 * 64 * 9, num_dists=18,
    doors_open=True)
_rg("BabyAI-GoToObjMaze-v0", "GoToMazeEnv", 8 * 64 * 9, num_dists=1)
_rg("BabyAI-GoToObjMazeOpen-v0", "GoToMazeEnv", 8 * 64 * 9, num_dists=1,
    doors_open=True)
for s, r in ((4, 3), (5, 3), (6, 3), (7, 3)):
    _rg(f"BabyAI-GoToObjMazeS{s}-v0", "GoToMazeEnv", 8 * s * s * 9,
        room_size=s, num_dists=1)
_rg("BabyAI-GoToObjMazeS4R2-v0", "GoToMazeEnv", 8 * 16 * 4,
    room_size=4, num_rows=2, num_cols=2, num_dists=1)
_rg("BabyAI-GoToSeq-v0", "GoToSeqEnv", 8 * 64 * 9 * 2, num_dists=18)
_rg("BabyAI-GoToSeqS5R2-v0", "GoToSeqEnv", 8 * 25 * 4 * 2,
    room_size=5, num_rows=2, num_cols=2, num_dists=8)
_rg("BabyAI-GoToObjDoor-v0", "GoToObjDoorEnv", 8 * 49,
    room_size=7, num_rows=1, num_cols=1, num_dists=5)
_rg("BabyAI-ActionObjDoor-v0", "ActionObjDoorEnv", 8 * 49,
    room_size=7, num_rows=1, num_cols=1, num_dists=5)

# BabyAI Open family.
_rg("BabyAI-Open-v0", "OpenMazeEnv", 8 * 64 * 9, num_dists=0)
for suffix, debug in (("", False), ("Debug", True)):
    _rg(f"BabyAI-OpenDoor{suffix}-v0", "OpenDoorEnv", 8 * 100,
        room_size=10, num_rows=1, num_cols=1, num_dists=0, debug=debug)
for variant in ("Color", "Loc"):
    _rg(f"BabyAI-OpenDoor{variant}-v0", "OpenDoorEnv", 8 * 100,
        room_size=10, num_rows=1, num_cols=1, num_dists=0)
_rg("BabyAI-OpenRedDoor-v0", "OpenDoorEnv", 8 * 25,
    room_size=5, num_rows=1, num_cols=1, num_dists=0, fixed_color=0)
_rg("BabyAI-OpenTwoDoors-v0", "OpenTwoDoorsEnv", 20 * 100,
    room_size=10, num_rows=1, num_cols=1, num_dists=0)
for n in (2, 4):
    for suffix, debug in (("", False), ("Debug", True)):
        _rg(f"BabyAI-OpenDoorsOrderN{n}{suffix}-v0", "OpenTwoDoorsEnv",
            20 * 100, room_size=10, num_rows=1, num_cols=1, num_dists=0,
            n_doors=n, debug=debug)
for suffix, debug in (("", False), ("Debug", True)):
    _rg(f"BabyAI-OpenRedBlueDoors{suffix}-v0", "OpenTwoDoorsEnv", 20 * 36,
        room_size=6, num_rows=1, num_cols=1, num_dists=0,
        fixed_pair=True, debug=debug)

# BabyAI Pickup family.
_rg("BabyAI-Pickup-v0", "PickupEnv", 8 * 64 * 9, num_dists=18)
_rg("BabyAI-UnblockPickup-v0", "PickupEnv", 8 * 64 * 9, num_dists=16,
    room_size=6)
_rg("BabyAI-PickupDist-v0", "PickupEnv", 8 * 49,
    room_size=7, num_rows=1, num_cols=1, num_dists=5)
_rg("BabyAI-PickupDistDebug-v0", "PickupEnv", 8 * 49,
    room_size=7, num_rows=1, num_cols=1, num_dists=5, debug=True)
_rg("BabyAI-PickupLoc-v0", "PickupEnv", 8 * 64,
    room_size=8, num_rows=1, num_cols=1, num_dists=8)
_rg("BabyAI-PickupAbove-v0", "PickupAboveEnv", 8 * 36 * 9, room_size=6,
    num_dists=0)

# BabyAI PutNext family.
_rg("BabyAI-PutNextLocal-v0", "PutNextEnv", 8 * 64,
    room_size=8, num_rows=1, num_cols=1, num_dists=8)
_rg("BabyAI-PutNextLocalS5N3-v0", "PutNextEnv", 8 * 25,
    room_size=5, num_rows=1, num_cols=1, num_dists=3)
_rg("BabyAI-PutNextLocalS6N4-v0", "PutNextEnv", 8 * 36,
    room_size=6, num_rows=1, num_cols=1, num_dists=4)
for s, n in ((4, 1), (5, 1), (5, 2), (6, 3), (7, 4)):
    _rg(f"BabyAI-PutNextS{s}N{n}-v0", "PutNextEnv", 8 * s * s * 2,
        room_size=s, num_rows=1, num_cols=2, num_dists=2 * n)
for s, n in ((5, 2), (6, 3), (7, 4)):
    _rg(f"BabyAI-PutNextS{s}N{n}Carrying-v0", "PutNextEnv", 8 * s * s * 2,
        room_size=s, num_rows=1, num_cols=2, num_dists=2 * n,
        carrying=True)
_rg("BabyAI-MoveTwoAcrossS5N2-v0", "PutNextEnv", 8 * 25 * 2,
    room_size=5, num_rows=1, num_cols=2, num_dists=4)
_rg("BabyAI-MoveTwoAcrossS8N9-v0", "PutNextEnv", 8 * 64 * 2,
    room_size=8, num_rows=1, num_cols=2, num_dists=18)

# BabyAI Unlock family.
_rg("BabyAI-Unlock-v0", "UnlockRGEnv", 8 * 36 * 9,
    num_rows=3, num_cols=3, room_size=6, target="open")
_rg("BabyAI-UnlockLocal-v0", "UnlockRGEnv", 8 * 64,
    num_rows=1, num_cols=2, room_size=8, target="open")
_rg("BabyAI-UnlockLocalDist-v0", "UnlockRGEnv", 8 * 64,
    num_rows=1, num_cols=2, room_size=8, target="open", num_dists=3)
_rg("BabyAI-KeyInBox-v0", "UnlockRGEnv", 8 * 36,
    num_rows=1, num_cols=2, room_size=6, target="open", hidden_key=True)
_rg("BabyAI-UnlockPickup-v0", "UnlockRGEnv", 8 * 36 * 2,
    num_rows=1, num_cols=2, room_size=6, target="pickup_box")
_rg("BabyAI-UnlockPickupDist-v0", "UnlockRGEnv", 8 * 36 * 2,
    num_rows=1, num_cols=2, room_size=6, target="pickup_box", num_dists=4)
_rg("BabyAI-BlockedUnlockPickup-v0", "UnlockRGEnv", 8 * 36 * 2,
    num_rows=1, num_cols=2, room_size=6, target="pickup_box", blocked=True)
_rg("BabyAI-UnlockToUnlock-v0", "UnlockRGEnv", 8 * 25 * 3,
    num_rows=1, num_cols=3, room_size=5, target="pickup_ball")
_rg("BabyAI-GoToImpUnlock-v0", "UnlockRGEnv", 8 * 36 * 9,
    num_rows=3, num_cols=3, room_size=6, target="goto_ball")

# KeyCorridor (BabyAI + MiniGrid share the generator).
for prefix in ("BabyAI", "MiniGrid"):
    for s, r in ((3, 1), (3, 2), (3, 3), (4, 3), (5, 3), (6, 3)):
        _rg(f"{prefix}-KeyCorridorS{s}R{r}-v0", "KeyCorridorEnv",
            30 * s * s * r, room_size=s + 3, num_rows=r, num_dists=0)
_rg("BabyAI-KeyCorridor-v0", "KeyCorridorEnv", 30 * 36 * 3,
    room_size=6, num_rows=3, num_dists=0)

# BabyAI Synth / Boss levels.
_rg("BabyAI-Synth-v0", "SynthEnv", 8 * 64 * 9, num_dists=18)
_rg("BabyAI-SynthLoc-v0", "SynthEnv", 8 * 64 * 9, num_dists=18)
_rg("BabyAI-SynthS5R2-v0", "SynthEnv", 8 * 25 * 4,
    room_size=5, num_rows=2, num_cols=2, num_dists=7)
_rg("BabyAI-SynthSeq-v0", "SynthEnv", 8 * 64 * 9 * 2, num_dists=18,
    seq=True)
_rg("BabyAI-MiniBossLevel-v0", "SynthEnv", 8 * 25 * 4,
    room_size=5, num_rows=2, num_cols=2, num_dists=7, seq=True)
_rg("BabyAI-BossLevel-v0", "SynthEnv", 8 * 64 * 9 * 2, num_dists=18,
    seq=True)
_rg("BabyAI-BossLevelNoUnlock-v0", "SynthEnv", 8 * 64 * 9 * 2,
    num_dists=18, seq=True)

# MiniGrid multi-room tasks.
_rg("MiniGrid-BlockedUnlockPickup-v0", "UnlockRGEnv", 16 * 36 * 2,
    num_rows=1, num_cols=2, room_size=6, target="pickup_box", blocked=True)
_rg("MiniGrid-LockedRoom-v0", "LockedRoomEnv", 10 * 19 * 19,
    num_rows=3, num_cols=3, room_size=7, num_dists=0)
_rg("MiniGrid-MultiRoom-N2-S4-v0", "MultiRoomEnv", 20 * 2,
    num_rows=1, num_cols=2, room_size=4, num_dists=0)
_rg("MiniGrid-MultiRoom-N4-S5-v0", "MultiRoomEnv", 20 * 4,
    num_rows=2, num_cols=2, room_size=5, num_dists=0)
_rg("MiniGrid-MultiRoom-N6-v0", "MultiRoomEnv", 20 * 6,
    num_rows=2, num_cols=3, room_size=6, num_dists=0)
_rg("MiniGrid-Playground-v0", "PlaygroundEnv", 100,
    num_rows=3, num_cols=3, room_size=7, num_dists=12)
_rg("MiniGrid-PutNear-6x6-N2-v0", "PutNextEnv", 5 * 36,
    room_size=6, num_rows=1, num_cols=1, num_dists=2)
_rg("MiniGrid-PutNear-8x8-N3-v0", "PutNextEnv", 5 * 64,
    room_size=8, num_rows=1, num_cols=1, num_dists=3)

# ObstructedMaze family (v1 fixes a generation bug upstream; identical
# semantics here).
_OM = dict(env_cls="ObstructedMazeEnv")
for tid, rows, cols, hidden, blocked in (
    ("1Dl", 1, 2, False, False),
    ("1Dlh", 1, 2, True, False),
    ("1Dlhb", 1, 2, True, True),
    ("2Dl", 1, 3, False, False),
    ("2Dlh", 1, 3, True, False),
    ("2Dlhb", 1, 3, True, True),
    ("1Q", 2, 2, True, True),
    ("2Q", 2, 3, True, True),
    ("Full", 3, 3, True, True),
):
    _rg(f"MiniGrid-ObstructedMaze-{tid}-v0", "ObstructedMazeEnv",
        16 * 36 * rows * cols, num_rows=rows, num_cols=cols,
        hidden_key=hidden, blocked=blocked)
for tid, rows, cols in (("1Q", 2, 2), ("2Dlhb", 1, 3), ("2Q", 2, 3),
                        ("Full", 3, 3)):
    _rg(f"MiniGrid-ObstructedMaze-{tid}-v1", "ObstructedMazeEnv",
        16 * 36 * rows * cols, num_rows=rows, num_cols=cols,
        hidden_key=True, blocked=True)

# WFC mazes (bank-of-maps adaptation; see wfc.py).
for preset in (
    "MazeSimple",
    "DungeonMazeScaled",
    "RoomsFabric",
    "ObstaclesBlackdots",
    "ObstaclesAngular",
    "ObstaclesHogs3",
):
    _rg(f"MiniGrid-WFC-{preset}-v0", "WFCEnv", 25 * 20,
        wfc_preset=preset, size=25)
