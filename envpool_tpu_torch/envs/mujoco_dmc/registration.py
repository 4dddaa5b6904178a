"""dm_control suite registration: the ids of
``envpool_tpu/envs/mujoco_dmc/registration.py`` (reference
``envpool/mujoco/dmc/registration.py``) in its order, each with
``max_episode_steps=1000``: all 51.
"""

from ...core.registry import register

_PATH = "envpool_tpu_torch.envs.mujoco_dmc"

_TASKS = [
    ("AcrobotSwingup-v1", "DmcAcrobotEnv", "swingup", {}),
    ("AcrobotSwingupSparse-v1", "DmcAcrobotEnv", "swingup_sparse", {}),
    ("PendulumSwingup-v1", "PendulumEnv", "swingup", {}),
    ("CartpoleBalance-v1", "CartpoleEnv", "balance", {}),
    ("CartpoleBalanceSparse-v1", "CartpoleEnv", "balance_sparse", {}),
    ("CartpoleSwingup-v1", "CartpoleEnv", "swingup", {}),
    ("CartpoleSwingupSparse-v1", "CartpoleEnv", "swingup_sparse", {}),
    ("CheetahRun-v1", "CheetahEnv", "run", {}),
    ("WalkerStand-v1", "WalkerEnv", "stand", {}),
    ("WalkerWalk-v1", "WalkerEnv", "walk", {}),
    ("WalkerRun-v1", "WalkerEnv", "run", {}),
    ("HopperStand-v1", "HopperEnv", "stand", {}),
    ("HopperHop-v1", "HopperEnv", "hop", {}),
    ("ReacherEasy-v1", "DmcReacherEnv", "easy", {}),
    ("ReacherHard-v1", "DmcReacherEnv", "hard", {}),
    ("PointMassEasy-v1", "PointMassEnv", "easy", {}),
    ("PointMassHard-v1", "PointMassEnv", "hard", {}),
    ("CartpoleTwoPoles-v1", "CartpoleEnv", "two_poles", {"n_poles": 2}),
    ("CartpoleThreePoles-v1", "CartpoleEnv", "three_poles", {"n_poles": 3}),
    ("SwimmerSwimmer6-v1", "SwimmerEnv", "swimmer6", {"n_links": 6}),
    ("SwimmerSwimmer15-v1", "SwimmerEnv", "swimmer15", {"n_links": 15}),
    ("BallInCupCatch-v1", "BallInCupEnv", "catch", {}),
    ("FishUpright-v1", "FishEnv", "upright", {}),
    ("FishSwim-v1", "FishEnv", "swim", {}),
    ("LqrLqr21-v1", "LqrEnv", "lqr_2_1", {}),
    ("LqrLqr62-v1", "LqrEnv", "lqr_6_2", {}),
    ("HumanoidStand-v1", "DmcHumanoidEnv", "stand", {}),
    ("HumanoidWalk-v1", "DmcHumanoidEnv", "walk", {}),
    ("HumanoidRun-v1", "DmcHumanoidEnv", "run", {}),
    ("HumanoidRunPureState-v1", "DmcHumanoidEnv", "run_pure_state", {}),
    ("HumanoidCMUStand-v1", "HumanoidCMUEnv", "stand", {}),
    ("HumanoidCMUWalk-v1", "HumanoidCMUEnv", "walk", {}),
    ("HumanoidCMURun-v1", "HumanoidCMUEnv", "run", {}),
    ("FingerSpin-v1", "FingerEnv", "spin", {}),
    ("FingerTurnEasy-v1", "FingerEnv", "turn_easy", {}),
    ("FingerTurnHard-v1", "FingerEnv", "turn_hard", {}),
    ("QuadrupedWalk-v1", "QuadrupedEnv", "walk", {}),
    ("QuadrupedRun-v1", "QuadrupedEnv", "run", {}),
    ("QuadrupedEscape-v1", "QuadrupedEnv", "escape", {}),
    ("QuadrupedFetch-v1", "QuadrupedEnv", "fetch", {}),
    ("ManipulatorBringBall-v1", "ManipulatorEnv", "bring_ball", {}),
    ("ManipulatorBringPeg-v1", "ManipulatorEnv", "bring_peg", {}),
    ("ManipulatorInsertBall-v1", "ManipulatorEnv", "insert_ball", {}),
    ("ManipulatorInsertPeg-v1", "ManipulatorEnv", "insert_peg", {}),
    ("StackerStack2-v1", "StackerEnv", "stack_2", {}),
    ("StackerStack4-v1", "StackerEnv", "stack_4", {}),
    ("DogStand-v1", "DogEnv", "stand", {}),
    ("DogWalk-v1", "DogEnv", "walk", {}),
    ("DogTrot-v1", "DogEnv", "trot", {}),
    ("DogRun-v1", "DogEnv", "run", {}),
    ("DogFetch-v1", "DogEnv", "fetch", {}),
]

for _task_id, _env_cls, _task_name, _extra in _TASKS:
    register(
        task_id=_task_id,
        import_path=_PATH,
        env_cls=_env_cls,
        task_name=_task_name,
        max_episode_steps=1000,
        **_extra,
    )
