"""MetaWorld v3 Sawyer env family (50 tasks), batched in PyTorch.

Counterpart of ``envpool_tpu/envs/metaworld`` (reference surface:
``envpool/mujoco/metaworld/``): obs (39,), action (4,) = an xyz mocap delta
(0.01 m a step, clamped to the hand box) and the gripper's effort, infos
success, near_object, grasp_success, grasp_reward, in_place_reward,
obj_to_target and unscaled_reward.
"""

from .sawyer import SawyerEnv

__all__ = ["SawyerEnv"]
