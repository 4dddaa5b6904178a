"""Atari-class pixel env base, batched over ``[N, ...]`` tensors.

Counterpart of ``envpool_tpu/envs/atari/arcade_env.py`` (behavioral
reference ``envpool/atari/atari_env.h``): noop/fire reset, frame skip with
the game-over freeze, max-pool of the last two frames, INTER_AREA resize,
frame stack, episodic life, reward clip, sticky actions and the
full→minimal action map.

The max-pool + resize of each step runs in K1 (``ops/cuda_image.py``): the
CUDA kernel on the card, its plain version on the CPU.  RGB frames fold
their three channels into the batch axis; a reset frame passes the same
frame twice.

Randomness comes in as draws made beforehand (see :meth:`reset_draws` and
:meth:`step_draws`): one integer per game ``init`` and per ``tick`` in
``[0, game.draw_n)``, the noop count, and the sticky-action uniform.  They
correspond one to one to the JAX env's key splits (``arcade_env.py:315,
375, 389``), so a test can feed the port the draws JAX made.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core import rng
from ...core.env import EnvOut, TorchEnv, tree_where
from ...core.specs import ArraySpec
from ...ops.cuda_image import fused_pool_resize

RAW_H, RAW_W = 210, 160


# ALE full action set (18 actions): id → (up, down, left, right, fire).
# Order per ale::Action — NOOP FIRE UP RIGHT LEFT DOWN UPRIGHT UPLEFT
# DOWNRIGHT DOWNLEFT UPFIRE RIGHTFIRE LEFTFIRE DOWNFIRE UPRIGHTFIRE
# UPLEFTFIRE DOWNRIGHTFIRE DOWNLEFTFIRE
# (reference: envpool/atari/atari_env.h full_action_space handling).
ALE_COMPONENTS = (
    (0, 0, 0, 0, 0),  # 0  NOOP
    (0, 0, 0, 0, 1),  # 1  FIRE
    (1, 0, 0, 0, 0),  # 2  UP
    (0, 0, 0, 1, 0),  # 3  RIGHT
    (0, 0, 1, 0, 0),  # 4  LEFT
    (0, 1, 0, 0, 0),  # 5  DOWN
    (1, 0, 0, 1, 0),  # 6  UPRIGHT
    (1, 0, 1, 0, 0),  # 7  UPLEFT
    (0, 1, 0, 1, 0),  # 8  DOWNRIGHT
    (0, 1, 1, 0, 0),  # 9  DOWNLEFT
    (1, 0, 0, 0, 1),  # 10 UPFIRE
    (0, 0, 0, 1, 1),  # 11 RIGHTFIRE
    (0, 0, 1, 0, 1),  # 12 LEFTFIRE
    (0, 1, 0, 0, 1),  # 13 DOWNFIRE
    (1, 0, 0, 1, 1),  # 14 UPRIGHTFIRE
    (1, 0, 1, 0, 1),  # 15 UPLEFTFIRE
    (0, 1, 0, 1, 1),  # 16 DOWNRIGHTFIRE
    (0, 1, 1, 0, 1),  # 17 DOWNLEFTFIRE
)


def full_to_minimal_map(minimal_set) -> "np.ndarray":
    """[18] table: each ALE full action → index into ``minimal_set``.

    Projection by joystick components: each full action maps to the
    minimal-set entry sharing the most components (matched components
    score +2, spurious components −1); exact matches win, unmatched
    actions fall back to NOOP-like behavior — how a real cartridge
    ignores switch bits it doesn't read.
    """
    table = np.zeros(18, np.int32)
    for full_id in range(18):
        fc = ALE_COMPONENTS[full_id]
        best, best_score = 0, -10**9
        for idx, ale_id in enumerate(minimal_set):
            mc = ALE_COMPONENTS[ale_id]
            if mc == fc:
                best, best_score = idx, 10**9
                break
            score = sum(
                2 if (a and b) else (-1 if (a != b) else 0)
                for a, b in zip(fc, mc)
            )
            if score > best_score:
                best, best_score = idx, score
        table[full_id] = best
    return table


class ArcadeGame:
    """One game core: batched tick/render functions over a state dict.

    ``tick`` advances every row ONE raw frame.  ``render_gray`` draws
    ``[N, H, W]`` float32 luma; ``render_rgb`` ``[N, 3, H, W]`` float32.
    ``init`` and ``tick`` each take one ``[N]`` integer draw in
    ``[0, draw_n)``.
    """

    action_set_size: int = 6
    has_fire: bool = True
    minimal_set: tuple = ()
    supported_modes: tuple = (0,)
    supported_difficulties: tuple = (0,)
    mode: int = 0
    difficulty: int = 0
    draw_n: int = 1

    def __init__(self, device: torch.device):
        self.device = device

    def init(self, draw: torch.Tensor) -> dict[str, torch.Tensor]:
        raise NotImplementedError

    def tick(self, g: dict, action: torch.Tensor, draw: torch.Tensor):
        """-> (g, reward: [N] f32, game_over: [N] bool)."""
        raise NotImplementedError

    def over(self, g: dict) -> torch.Tensor:
        raise NotImplementedError

    def lives(self, g: dict) -> torch.Tensor:
        n = next(iter(g.values())).shape[0]
        return torch.zeros(n, dtype=torch.int32, device=self.device)

    def render_gray(self, g: dict) -> torch.Tensor:
        raise NotImplementedError

    def render_rgb(self, g: dict) -> torch.Tensor:
        raise NotImplementedError

    def ram(self, g: dict) -> torch.Tensor:
        n = next(iter(g.values())).shape[0]
        return torch.zeros((n, 128), dtype=torch.uint8, device=self.device)


class ArcadeEnv(TorchEnv):
    """Generic Atari-pipeline env over an :class:`ArcadeGame`."""

    GAME_CLS: type[ArcadeGame] = ArcadeGame

    DEFAULT_CONFIG = {
        "stack_num": 4,
        "frame_skip": 4,
        "noop_max": 30,
        "zero_discount_on_life_loss": False,
        "episodic_life": False,
        "reward_clip": False,
        "use_fire_reset": True,
        "img_height": 84,
        "img_width": 84,
        "task": "",
        "mode": -1,
        "difficulty": -1,
        "full_action_space": False,
        "repeat_action_probability": 0.0,
        "use_inter_area_resize": True,
        "gray_scale": True,
    }

    def __init__(self, config):
        super().__init__(config)
        self.game = self._make_game()
        mode = int(config["mode"])
        difficulty = int(config["difficulty"])
        if mode >= 0:
            if mode not in self.game.supported_modes:
                raise ValueError(
                    f"mode {mode} not supported by "
                    f"{type(self.game).__name__}; supported: "
                    f"{self.game.supported_modes}"
                )
            self.game.mode = mode
        else:
            self.game.mode = int(self.game.supported_modes[0])
        if difficulty >= 0:
            if difficulty not in self.game.supported_difficulties:
                raise ValueError(
                    f"difficulty {difficulty} not supported by "
                    f"{type(self.game).__name__}; supported: "
                    f"{self.game.supported_difficulties}"
                )
            self.game.difficulty = difficulty
        else:
            self.game.difficulty = int(self.game.supported_difficulties[0])
        if bool(config["full_action_space"]):
            minimal = self.game.minimal_set or tuple(
                range(self.game.action_set_size)
            )
            self._full_map = torch.as_tensor(
                full_to_minimal_map(minimal), device=self.device
            )
        else:
            self._full_map = None

    def _make_game(self) -> ArcadeGame:
        return self.GAME_CLS(self.device)

    # -- config helpers ----------------------------------------------------

    @property
    def _stack_num(self) -> int:
        return int(self.config["stack_num"])

    @property
    def _frame_skip(self) -> int:
        return int(self.config["frame_skip"])

    @property
    def _noop_max(self) -> int:
        return max(int(self.config["noop_max"]), 1)

    @property
    def _gray(self) -> bool:
        return bool(self.config["gray_scale"])

    @property
    def _img_hw(self) -> tuple[int, int]:
        return int(self.config["img_height"]), int(self.config["img_width"])

    @property
    def _channels(self) -> int:
        return 1 if self._gray else 3

    @property
    def _fire_reset(self) -> bool:
        return bool(self.config["use_fire_reset"]) and self.game.has_fire

    # -- specs -------------------------------------------------------------

    def state_spec(self):
        h, w = self._img_hw
        return {
            "obs": ArraySpec(
                np.uint8, (self._stack_num * self._channels, h, w), 0, 255
            ),
            "info:lives": ArraySpec(np.int32, ()),
            "info:reward": ArraySpec(np.float32, ()),
            "info:terminated": ArraySpec(np.int32, (), 0, 1),
            "info:ram": ArraySpec(np.uint8, (128,), 0, 255),
        }

    def action_spec(self):
        n = 18 if self._full_map is not None else self.game.action_set_size
        return {
            "action": ArraySpec(np.int32, (), 0, n - 1, is_discrete=True)
        }

    # -- random draws ------------------------------------------------------

    def reset_draws(self, sub: torch.Tensor) -> dict[str, torch.Tensor]:
        """``init`` [N], ``noop`` [N] in [0, noop_max), ``tick`` [N, noop_max+1].

        ``tick[:, i]`` feeds noop tick ``i``; ``tick[:, noop_max]`` the
        fire tick (JAX: ``fold_in(k_tick, i)``).
        """
        d = self.game.draw_n
        nm = self._noop_max
        return {
            "init": rng.randint(sub, 0, d),
            "noop": rng.randint(sub, 1, nm),
            "tick": torch.stack(
                [rng.randint(sub, 2 + i, d) for i in range(nm + 1)], dim=1
            ),
        }

    def step_draws(self, sub: torch.Tensor) -> dict[str, torch.Tensor]:
        """``sticky`` [N] uniform in [0, 1) and ``tick`` [N, frame_skip]."""
        d = self.game.draw_n
        return {
            "sticky": rng.uniform(sub, 0),
            "tick": torch.stack(
                [rng.randint(sub, 1 + i, d) for i in range(self._frame_skip)],
                dim=1,
            ),
        }

    # -- frame pipeline ----------------------------------------------------

    def _render(self, g: dict) -> torch.Tensor:
        """Raw frames: [N, H, W] gray or [N, 3, H, W] rgb, float32."""
        if self._gray:
            return self.game.render_gray(g)
        return self.game.render_rgb(g)

    def _shrink(self, f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
        """Max-pool two raw frames and resize: [N, (1|3), h, w] uint8 (K1)."""
        n = f0.shape[0]
        h, w = self._img_hw
        pair = torch.stack([f0, f1], dim=1)  # [N, 2, (3,) H, W]
        if not self._gray:
            pair = pair.transpose(1, 2).reshape(n * 3, 2, RAW_H, RAW_W)
        out = fused_pool_resize(pair.contiguous(), (h, w))
        return out.reshape(n, self._channels, h, w)

    def _push(self, stack, frame, push_all):
        """Frame-stack update (atari_env.h:308-346)."""
        pushed = torch.cat([stack[:, 1:], frame[:, None]], dim=1)
        filled = frame[:, None].expand_as(stack)
        return tree_where(push_all, filled, pushed)

    def _obs_dict(self, stack, g, reward_raw, terminated):
        n = stack.shape[0]
        h, w = self._img_hw
        return {
            "obs": stack.reshape(n, self._stack_num * self._channels, h, w),
            "info:lives": self.game.lives(g),
            "info:reward": reward_raw.to(torch.float32),
            "info:terminated": terminated.to(torch.int32),
            "info:ram": self.game.ram(g),
        }

    # -- render ------------------------------------------------------------

    render_size = (RAW_H, RAW_W)

    def render_state(self, state):
        """Raw-resolution RGB frames of the games' states: ``[N, H, W, 3]``
        uint8."""
        rgb = self.game.render_rgb(state["game"])  # [N, 3, H, W] float32
        return torch.clamp(torch.round(rgb.permute(0, 2, 3, 1)), 0, 255).to(torch.uint8)

    # -- reset -------------------------------------------------------------

    def reset_env(self, draws):
        n = draws["noop"].shape[0]
        h, w = self._img_hw
        state = {
            "game": self.game.init(torch.zeros_like(draws["init"])),
            "stack": torch.zeros(
                (n, self._stack_num, self._channels, h, w),
                dtype=torch.uint8,
                device=self.device,
            ),
            "last_action": torch.zeros(n, dtype=torch.int32, device=self.device),
        }
        full = torch.ones(n, dtype=torch.bool, device=self.device)
        return self._reset_impl(state, draws, full)

    def reset_env_from(self, state, draws, full):
        if not bool(self.config["episodic_life"]):
            full = torch.ones_like(full)
        return self._reset_impl(state, draws, full)

    def _reset_impl(self, state, draws, full):
        """noop/fire reset (atari_env.h:168-200)."""
        full = full | self.game.over(state["game"])
        g = tree_where(full, self.game.init(draws["init"]), state["game"])
        noop_max = self._noop_max
        noop = draws["noop"] + 1 - int(self._fire_reset)
        zeros = torch.zeros_like(noop)
        for i in range(noop_max):
            g2 = self.game.tick(g, zeros, draws["tick"][:, i])[0]
            g = tree_where(i < noop, g2, g)
        if self._fire_reset:
            g = self.game.tick(
                g, torch.ones_like(noop), draws["tick"][:, noop_max]
            )[0]
        raw = self._render(g)
        stack = self._push(state["stack"], self._shrink(raw, raw), full)
        n = noop.shape[0]
        new_state = {
            "game": g,
            "stack": stack,
            "last_action": torch.zeros(n, dtype=torch.int32, device=self.device),
        }
        zero = torch.zeros(n, dtype=torch.float32, device=self.device)
        obs = self._obs_dict(stack, g, zero, torch.zeros_like(full))
        return new_state, obs

    # -- step --------------------------------------------------------------

    def step_env(self, state, action, draws):
        cfg = self.config
        frame_skip = self._frame_skip
        action = action.to(torch.int32)
        if self._full_map is not None:
            action = self._full_map[torch.clamp(action, 0, 17).long()]
        p = float(cfg["repeat_action_probability"])
        if p > 0:
            action = torch.where(
                draws["sticky"] < p, state["last_action"], action
            )

        g = state["game"]
        prev_lives = self.game.lives(g)
        n = action.shape[0]
        reward = torch.zeros(n, dtype=torch.float32, device=self.device)
        game_over = torch.zeros(n, dtype=torch.bool, device=self.device)
        pooled = min(frame_skip, 2)
        frames = []
        for i in range(frame_skip):
            g2, r, over = self.game.tick(g, action, draws["tick"][:, i])
            # Stop acting once the game is over mid-skip (atari_env.h:207).
            g = tree_where(game_over, g, g2)
            reward = reward + torch.where(game_over, 0.0, r)
            game_over = game_over | over
            if i >= frame_skip - pooled:
                frames.append(self._render(g))
        frame = self._shrink(frames[0], frames[-1])
        stack = self._push(state["stack"], frame, torch.zeros_like(game_over))

        lives = self.game.lives(g)
        terminated = game_over
        if bool(cfg["episodic_life"]):
            terminated = terminated | ((0 < lives) & (lives < prev_lives))
        discount = None
        if bool(cfg["zero_discount_on_life_loss"]):
            discount = ((lives == prev_lives) & ~terminated).to(torch.float32)
        info_reward = reward
        if bool(cfg["reward_clip"]):
            reward = torch.sign(reward)

        new_state = {"game": g, "stack": stack, "last_action": action}
        return EnvOut(
            state=new_state,
            obs=self._obs_dict(stack, g, info_reward, game_over),
            reward=reward.to(torch.float32),
            terminated=terminated,
            discount=discount,
        )

