"""FrankaKitchen-v1: multitask kitchen manipulation, batched in PyTorch.

Counterpart of ``envpool_tpu/envs/robotics/kitchen.py`` (reference:
``envpool/mujoco/robotics/kitchen.h``, gymnasium_robotics
``envs/franka_kitchen/kitchen_env.py``): a 9-dof arm servo, the end
effector a fixed linear map of the arm's qpos (from ``default_rng(11)``, as
the JAX env builds it), seven elements that move toward their goal
configuration while the end effector dwells near their handle; the reward
counts the tasks completed this step (within ``BONUS_THRESH`` of the
goal), and the episode ends when every task is done.  The elements' dofs
are gathered as one ``[N, 7, 7]`` table (padded), so every element moves
in one program.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.env import EnvOut, TorchEnv
from ...core.rng import Draws
from ...core.specs import ArraySpec
from ...ops.batched import inv, norm

__all__ = ["FrankaKitchenEnv"]

_DT = 0.08  # frame_skip 40 * 0.002
BONUS_THRESH = 0.3

TASKS = (
    "bottom burner",
    "top burner",
    "light switch",
    "slide cabinet",
    "hinge cabinet",
    "microwave",
    "kettle",
)
# Object-dof slices within qpos (OBS_ELEMENT_INDICES, kitchen_env.py:27-35).
ELEMENT_INDICES = {
    "bottom burner": (11, 12),
    "top burner": (15, 16),
    "light switch": (17, 18),
    "slide cabinet": (19,),
    "hinge cabinet": (20, 21),
    "microwave": (22,),
    "kettle": (23, 24, 25, 26, 27, 28, 29),
}
ELEMENT_GOALS = {
    "bottom burner": (-0.88, -0.01),
    "top burner": (-0.92, -0.01),
    "light switch": (-0.69, -0.05),
    "slide cabinet": (0.37,),
    "hinge cabinet": (0.0, 1.45),
    "microwave": (-0.75,),
    "kettle": (-0.23, 0.75, 1.62, 0.99, 0.0, 0.0, -0.06),
}
# Element handle locations in the (surrogate) workspace.
ELEMENT_POS = {
    "bottom burner": (-0.3, 0.5, 0.6),
    "top burner": (-0.3, 0.5, 1.0),
    "light switch": (-0.2, 0.6, 1.4),
    "slide cabinet": (0.3, 0.5, 1.2),
    "hinge cabinet": (0.5, 0.5, 1.2),
    "microwave": (-0.6, 0.4, 0.8),
    "kettle": (0.0, 0.4, 0.8),
}
INIT_QPOS = np.zeros(30, np.float32)
INIT_QPOS[:9] = [
    0.148388, -1.768486, 1.843903, -2.476858, 0.260252, 0.712533,
    1.595154, 0.047927, 0.037756,
]
INIT_QPOS[23:30] = [-0.269, 0.35, 1.62, 0.99, 0.0, 0.0, 0.0]

# The elements' dofs as one padded table: [7, 7] qpos indices (padding
# repeats the last dof), their goals and a mask of the real ones.
_WIDTH = 7
_IDX = np.asarray([list(ELEMENT_INDICES[t]) + [ELEMENT_INDICES[t][-1]]
                   * (_WIDTH - len(ELEMENT_INDICES[t])) for t in TASKS])
_GOAL = np.asarray([list(ELEMENT_GOALS[t]) + [0.0] * (_WIDTH - len(ELEMENT_GOALS[t]))
                    for t in TASKS], np.float32)
_MASK = np.asarray([[i < len(ELEMENT_GOALS[t]) for i in range(_WIDTH)] for t in TASKS])


class FrankaKitchenEnv(TorchEnv):
    DEFAULT_CONFIG = {
        "reward_threshold": 0.0,
        "xml_file": "kitchen_franka/kitchen_assets/kitchen_env_model.xml",
        "frame_skip": 40,
        "tasks_to_complete": list(TASKS),
        "terminate_on_tasks_completed": True,
        "remove_task_when_completed": True,
        "robot_noise_ratio": 0.01,
        "object_noise_ratio": 0.0005,
    }

    def __init__(self, config):
        super().__init__(config)
        self.tasks = [str(t) for t in config["tasks_to_complete"]]
        self.terminate_on_completed = bool(config["terminate_on_tasks_completed"])
        rng = np.random.default_rng(11)
        J = np.zeros((3, 9), np.float32)
        J[0, 0], J[1, 1], J[2, 3] = 0.5, 0.5, 0.4
        J += 0.02 * rng.standard_normal(J.shape).astype(np.float32)
        self._ee_jac = J
        self._ee0 = np.asarray([0.0, 0.3, 1.0], np.float32)
        dev = self.device
        self._J = torch.as_tensor(J, device=dev)
        self._e0 = torch.as_tensor(self._ee0, device=dev)
        self._qpos0 = torch.as_tensor(INIT_QPOS, device=dev)
        self._todo0 = torch.as_tensor(
            [1.0 if t in self.tasks else 0.0 for t in TASKS], device=dev)
        self._idx = torch.as_tensor(_IDX, device=dev)
        self._goal = torch.as_tensor(_GOAL, device=dev)
        self._mask = torch.as_tensor(_MASK, device=dev)
        self._handle = torch.as_tensor(np.asarray([ELEMENT_POS[t] for t in TASKS],
                                                  np.float32), device=dev)
        self._goals = {t: torch.as_tensor(np.asarray(ELEMENT_GOALS[t], np.float32),
                                          device=dev) for t in TASKS}

    def state_spec(self):
        inf = float("inf")
        spec = {
            "obs:observation": ArraySpec(np.float32, (59,), -inf, inf),
            "info:tasks_to_complete": ArraySpec(np.float32, (7,), 0.0, 1.0),
            "info:step_task_completions": ArraySpec(np.float32, (7,), 0.0, 1.0),
            "info:episode_task_completions": ArraySpec(np.float32, (7,), 0.0, 1.0),
            "info:qpos0": ArraySpec(np.float32, (30,)),
            "info:qvel0": ArraySpec(np.float32, (29,)),
        }
        for t in TASKS:
            n = len(ELEMENT_GOALS[t])
            spec[f"obs:desired_goal:{t}"] = ArraySpec(np.float32, (n,), -inf, inf)
            spec[f"obs:achieved_goal:{t}"] = ArraySpec(np.float32, (n,), -inf, inf)
        return spec

    def action_spec(self):
        return {"action": ArraySpec(np.float32, (9,), -1.0, 1.0)}

    def _obs(self, st):
        qpos, qvel = st["qpos"], st["qvel"]
        n = qpos.shape[0]
        out = {
            "obs:observation": torch.cat([qpos[:, :9], qvel[:, :9], qpos[:, 9:30],
                                          qvel[:, 9:29]], 1),
            "info:tasks_to_complete": st["todo"],
            "info:step_task_completions": st["step_done"],
            "info:episode_task_completions": st["episode_done"],
            "info:qpos0": self._qpos0.expand(n, 30),
            "info:qvel0": qvel.new_zeros(n, 29),
        }
        for t in TASKS:
            lo, k = ELEMENT_INDICES[t][0], len(ELEMENT_INDICES[t])
            out[f"obs:achieved_goal:{t}"] = qpos[:, lo:lo + k]
            out[f"obs:desired_goal:{t}"] = self._goals[t].expand(n, k)
        return out

    def plan_reset(self, d):
        """The reset draws nothing."""
        del d

    def reset_draws(self, sub):
        return Draws(sub).out

    def reset_env(self, draws):
        n = draws["rows"].shape[0]
        zeros7 = self._todo0.new_zeros(n, 7)
        st = {
            "qpos": self._qpos0.expand(n, 30).clone(),
            "qvel": self._qpos0.new_zeros(n, 29),
            "todo": self._todo0.expand(n, 7).clone(),
            "step_done": zeros7,
            "episode_done": zeros7.clone(),
        }
        return st, self._obs(st)

    def step_env(self, state, action, draws):
        del draws
        a = torch.clamp(action.reshape(-1, 9).to(torch.float32), -1.0, 1.0)
        qpos, qvel = state["qpos"], state["qvel"]
        arm = qpos[:, :9]
        target = a * 2.5
        delta = torch.clamp(0.3 * (target - arm), -0.3, 0.3)
        new_arm = arm + delta
        arm_vel = delta * inv(_DT)
        ee = self._e0 + new_arm @ self._J.T
        ee_speed = norm(arm_vel @ self._J.T)

        # The elements move toward their goal while the ee dwells near their
        # handle (surrogate interaction); no two elements share a dof.
        near = norm(ee[:, None] - self._handle) < 0.35                       # [N, 7]
        rate = torch.where(near, torch.clamp_max(0.08 * ee_speed, 0.5)[:, None], 0.0)
        flat = self._idx.reshape(-1)
        cur = qpos[:, flat].reshape(-1, 7, _WIDTH)
        nxt = cur + rate[..., None] * (self._goal - cur)
        new_qpos = torch.cat([new_arm, qpos[:, 9:]], 1)
        cols = flat[self._mask.reshape(-1)]
        new_qpos[:, cols] = nxt.reshape(-1, 7 * _WIDTH)[:, self._mask.reshape(-1)]
        new_qvel = torch.cat([arm_vel, qvel[:, 9:]], 1)

        # Completion bookkeeping (kitchen_env.step).
        moved = new_qpos[:, flat].reshape(-1, 7, _WIDTH)
        err = torch.where(self._mask, moved - self._goal, 0.0)
        d = norm(err)
        todo = state["todo"]
        complete = ((d < BONUS_THRESH) & (todo > 0)).to(torch.float32)
        todo = todo - complete
        episode_done = torch.maximum(state["episode_done"], complete)
        reward = complete.sum(1)
        if self.terminate_on_completed:
            terminated = episode_done.sum(1) >= float(len(self.tasks))
        else:
            terminated = torch.zeros_like(reward, dtype=torch.bool)
        st = {
            "qpos": new_qpos,
            "qvel": new_qvel,
            "todo": todo,
            "step_done": complete,
            "episode_done": episode_done,
        }
        return EnvOut(state=st, obs=self._obs(st), reward=reward, terminated=terminated)
