"""dm_control suite registration: the ids of
``envpool_tpu/envs/mujoco_dmc/registration.py`` whose physics the port has
(reference ``envpool/mujoco/dmc/registration.py``), each with
``max_episode_steps=1000``.

Left out until the port's physics has what their models need
(``physics.dynamics.check_supported``): point_mass, manipulator, stacker
and dog (tendon transmissions), fish and quadruped (also affine-bias
actuators), ball_in_cup (spatial tendons), lqr (spatial tendons) and
finger (body-body contacts).
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
    ("CartpoleTwoPoles-v1", "CartpoleEnv", "two_poles", {"n_poles": 2}),
    ("CartpoleThreePoles-v1", "CartpoleEnv", "three_poles", {"n_poles": 3}),
    ("SwimmerSwimmer6-v1", "SwimmerEnv", "swimmer6", {"n_links": 6}),
    ("SwimmerSwimmer15-v1", "SwimmerEnv", "swimmer15", {"n_links": 15}),
    ("HumanoidStand-v1", "DmcHumanoidEnv", "stand", {}),
    ("HumanoidWalk-v1", "DmcHumanoidEnv", "walk", {}),
    ("HumanoidRun-v1", "DmcHumanoidEnv", "run", {}),
    ("HumanoidRunPureState-v1", "DmcHumanoidEnv", "run_pure_state", {}),
    ("HumanoidCMUStand-v1", "HumanoidCMUEnv", "stand", {}),
    ("HumanoidCMUWalk-v1", "HumanoidCMUEnv", "walk", {}),
    ("HumanoidCMURun-v1", "HumanoidCMUEnv", "run", {}),
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
