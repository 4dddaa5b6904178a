"""Gymnasium-Robotics registration: the 157 ids of
``envpool_tpu/envs/robotics/registration.py`` (reference
``envpool/mujoco/robotics/registration.py:305-520``), in its order, with
its configs: Fetch 16, HandReach 4, HandManipulate 108, Adroit 8,
PointMaze 20, FrankaKitchen 1.
"""

from typing import Any

from ...core.registry import register

_PATH = "envpool_tpu_torch.envs.robotics"

# -- Fetch (registration.py:308-330,370-380) -------------------------------

_FETCH_TASKS: dict[str, dict[str, Any]] = {
    "FetchReach": {
        "xml_file": "fetch/reach.xml",
        "has_object": False,
        "block_gripper": True,
        "target_in_the_air": True,
        "gripper_extra_height": 0.2,
        "obj_range": 0.15,
        "target_range": 0.15,
        "distance_threshold": 0.05,
    },
    "FetchPush": {
        "xml_file": "fetch/push.xml",
        "has_object": True,
        "block_gripper": True,
        "target_in_the_air": False,
        "gripper_extra_height": 0.0,
        "obj_range": 0.15,
        "target_range": 0.15,
        "distance_threshold": 0.05,
    },
    "FetchPickAndPlace": {
        "xml_file": "fetch/pick_and_place.xml",
        "has_object": True,
        "block_gripper": False,
        "target_in_the_air": True,
        "gripper_extra_height": 0.2,
        "obj_range": 0.15,
        "target_range": 0.15,
        "distance_threshold": 0.05,
    },
    "FetchSlide": {
        "xml_file": "fetch/slide.xml",
        "has_object": True,
        "block_gripper": True,
        "target_in_the_air": False,
        "gripper_extra_height": -0.02,
        "target_offset_x": 0.4,
        "obj_range": 0.1,
        "target_range": 0.3,
        "distance_threshold": 0.05,
        "object_friction_decel": 0.3,
    },
}

for _task, _kw in _FETCH_TASKS.items():
    for _suffix, _rt in (("", "sparse"), ("Dense", "dense")):
        for _v in ("v1", "v4"):
            register(
                task_id=f"{_task}{_suffix}-{_v}",
                import_path=_PATH,
                env_cls="FetchEnv",
                max_episode_steps=50,
                reward_type=_rt,
                **_kw,
            )

# -- HandReach (registration.py:382-405) -----------------------------------

for _suffix, _rt in (("", "sparse"), ("Dense", "dense")):
    for _v in ("v0", "v3"):
        register(
            task_id=f"HandReach{_suffix}-{_v}",
            import_path=_PATH,
            env_cls="HandReachEnv",
            max_episode_steps=50,
            reward_type=_rt,
        )

# -- HandManipulate (registration.py:407-480) ------------------------------

_HAND_OBJECTS: dict[str, dict[str, Any]] = {
    "Block": {
        "xml_file": "hand/manipulate_block.xml",
        "touch_xml_file": "hand/manipulate_block_touch_sensors.xml",
        "distance_threshold": 0.01,
        "randomize_initial_rotation": True,
        "ignore_z_target_rotation": False,
        "variants": {
            "": ("random", "xyz"),
            "Full": ("random", "xyz"),
            "RotateParallel": ("ignore", "parallel"),
            "RotateXYZ": ("ignore", "xyz"),
            "RotateZ": ("ignore", "z"),
        },
        "touch_variants": ["", "RotateParallel", "RotateXYZ", "RotateZ"],
    },
    "Egg": {
        "xml_file": "hand/manipulate_egg.xml",
        "touch_xml_file": "hand/manipulate_egg_touch_sensors.xml",
        "distance_threshold": 0.01,
        "randomize_initial_rotation": True,
        "ignore_z_target_rotation": False,
        "variants": {
            "": ("random", "xyz"),
            "Full": ("random", "xyz"),
            "Rotate": ("ignore", "xyz"),
        },
        "touch_variants": ["", "Rotate"],
    },
    "Pen": {
        "xml_file": "hand/manipulate_pen.xml",
        "touch_xml_file": "hand/manipulate_pen_touch_sensors.xml",
        "distance_threshold": 0.05,
        "randomize_initial_rotation": False,
        "ignore_z_target_rotation": True,
        "variants": {
            "": ("random", "xyz"),
            "Full": ("random", "xyz"),
            "Rotate": ("ignore", "xyz"),
        },
        "touch_variants": ["", "Rotate"],
    },
}

for _obj, _conf in _HAND_OBJECTS.items():
    for _variant, (_tp, _tr) in _conf["variants"].items():
        for _suffix, _rt in (("", "sparse"), ("Dense", "dense")):
            for _v in ("v0", "v1"):
                register(
                    task_id=f"HandManipulate{_obj}{_variant}{_suffix}-{_v}",
                    import_path=_PATH,
                    env_cls="HandManipulateEnv",
                    max_episode_steps=100,
                    xml_file=_conf["xml_file"],
                    reward_type=_rt,
                    distance_threshold=_conf["distance_threshold"],
                    target_position=_tp,
                    target_rotation=_tr,
                    randomize_initial_rotation=_conf[
                        "randomize_initial_rotation"
                    ],
                    ignore_z_target_rotation=_conf["ignore_z_target_rotation"],
                )
    for _variant in _conf["touch_variants"]:
        _tp, _tr = _conf["variants"][_variant]
        for _touch_suffix, _touch in (
            ("_BooleanTouchSensors", "boolean"),
            ("_ContinuousTouchSensors", "sensordata"),
        ):
            for _suffix, _rt in (("", "sparse"), ("Dense", "dense")):
                for _v in ("v0", "v1"):
                    register(
                        task_id=(
                            f"HandManipulate{_obj}{_variant}"
                            f"{_touch_suffix}{_suffix}-{_v}"
                        ),
                        import_path=_PATH,
                        env_cls="HandManipulateEnv",
                        max_episode_steps=100,
                        xml_file=_conf["touch_xml_file"],
                        reward_type=_rt,
                        distance_threshold=_conf["distance_threshold"],
                        target_position=_tp,
                        target_rotation=_tr,
                        randomize_initial_rotation=_conf[
                            "randomize_initial_rotation"
                        ],
                        ignore_z_target_rotation=_conf[
                            "ignore_z_target_rotation"
                        ],
                        touch_get_obs=_touch,
                    )

# -- Adroit (registration.py:482-492) --------------------------------------

_ADROIT_TASKS: dict[str, dict[str, Any]] = {
    "AdroitHandDoor": {
        "xml_file": "adroit_hand/adroit_door.xml",
        "adroit_task": "door",
        "obs_dim": 39,
        "action_dim": 28,
        "qpos_dim": 30,
        "qvel_dim": 30,
        "reset_dim": 3,
    },
    "AdroitHandHammer": {
        "xml_file": "adroit_hand/adroit_hammer.xml",
        "adroit_task": "hammer",
        "obs_dim": 46,
        "action_dim": 26,
        "qpos_dim": 33,
        "qvel_dim": 33,
        "reset_dim": 3,
    },
    "AdroitHandPen": {
        "xml_file": "adroit_hand/adroit_pen.xml",
        "adroit_task": "pen",
        "obs_dim": 45,
        "action_dim": 24,
        "qpos_dim": 30,
        "qvel_dim": 30,
        "reset_dim": 4,
    },
    "AdroitHandRelocate": {
        "xml_file": "adroit_hand/adroit_relocate.xml",
        "adroit_task": "relocate",
        "obs_dim": 39,
        "action_dim": 30,
        "qpos_dim": 36,
        "qvel_dim": 36,
        "reset_dim": 6,
    },
}

for _task, _kw in _ADROIT_TASKS.items():
    for _suffix, _rt in (("", "dense"), ("Sparse", "sparse")):
        register(
            task_id=f"{_task}{_suffix}-v1",
            import_path=_PATH,
            env_cls="AdroitEnv",
            max_episode_steps=200,
            reward_type=_rt,
            **_kw,
        )

# -- PointMaze (registration.py:494-507) -----------------------------------

_POINT_MAZE_TASKS = {
    "PointMaze_Open": ("OPEN", 300),
    "PointMaze_UMaze": ("U_MAZE", 300),
    "PointMaze_Medium": ("MEDIUM_MAZE", 600),
    "PointMaze_Large": ("LARGE_MAZE", 800),
    "PointMaze_Open_Diverse_G": ("OPEN_DIVERSE_G", 300),
    "PointMaze_Open_Diverse_GR": ("OPEN_DIVERSE_GR", 300),
    "PointMaze_Medium_Diverse_G": ("MEDIUM_MAZE_DIVERSE_G", 600),
    "PointMaze_Medium_Diverse_GR": ("MEDIUM_MAZE_DIVERSE_GR", 600),
    "PointMaze_Large_Diverse_G": ("LARGE_MAZE_DIVERSE_G", 800),
    "PointMaze_Large_Diverse_GR": ("LARGE_MAZE_DIVERSE_GR", 800),
}

for _task, (_map, _steps) in _POINT_MAZE_TASKS.items():
    for _suffix, _rt in (("", "sparse"), ("Dense", "dense")):
        register(
            task_id=f"{_task}{_suffix}-v3",
            import_path=_PATH,
            env_cls="PointMazeEnv",
            max_episode_steps=_steps,
            maze_map=_map,
            reward_type=_rt,
            continuing_task=True,
            reset_target=False,
            maze_size_scaling=1.0,
            maze_height=0.4,
            position_noise_range=0.25,
        )

# -- FrankaKitchen (registration.py:509-520) -------------------------------

register(
    task_id="FrankaKitchen-v1",
    import_path=_PATH,
    env_cls="FrankaKitchenEnv",
    max_episode_steps=280,
)
