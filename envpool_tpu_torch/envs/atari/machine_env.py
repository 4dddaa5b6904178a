"""Atari 2600 machine env: a real cartridge ROM (2K/4K plain, 8K F8, 16K
F6) on the 6502+TIA emulator, behind the standard Atari pipeline.

Counterpart of ``envpool_tpu/envs/atari/machine_env.py``.  Every tick runs
one video frame of every env through K2 (``ops/cuda_machine.py``: the CUDA
kernel on the card, the plain version on the CPU), then the pipeline
renders the line records (``tia.render_frame``), letterboxes them into the
210×160 canvas and shrinks them with K1.

ALE actions map to console inputs: the joystick directions clear SWCHA
bits (active-low, P0 nibble) and FIRE pulls INPT4 bit 7 low.  Reward and
termination come from a per-ROM preset (``game=``, :mod:`rom_presets`) or
from the ``ram_reward_addr`` / ``ram_lives_addr`` hooks.
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.cuda_machine import machine_frame
from . import cpu6502, machine_kernel, tia
from .arcade_env import ALE_COMPONENTS, RAW_H, RAW_W, ArcadeEnv, ArcadeGame

# SWCHA player-0 nibble (active low): bit7 right, bit6 left, bit5 down,
# bit4 up.  Per ALE action: the SWCHA byte and INPT4.
_COMP = np.asarray(ALE_COMPONENTS, np.int64)  # [18, 5] up,down,left,right,fire
_SWCHA = 0xFF ^ (_COMP[:, :4] @ np.array([0x10, 0x20, 0x40, 0x80]))
_INPT4 = np.where(_COMP[:, 4] > 0, 0x00, 0x80)


class Machine2600Game(ArcadeGame):
    """A batch of 2600 machines as an ArcadeGame core (tick = one frame).

    With a ``preset`` the game gets ALE-style per-ROM semantics: multi-byte
    BCD/raw score decode, optional opponent score (zero-sum reward), lives
    byte and minimal action set.
    """

    action_set_size = 18
    has_fire = True

    def __init__(self, device, rom: np.ndarray, reward_addr: int = -1,
                 lives_addr: int = -1, preset: dict | None = None):
        super().__init__(device)
        self.rom_np = np.asarray(rom, np.uint8)
        self.tables = machine_kernel.build_tables(self.rom_np, device)
        self.reward_addr = int(reward_addr)
        self.lives_addr = int(lives_addr)
        self.preset = preset
        self._action_map = None
        if preset is not None:
            self.minimal_set = tuple(preset["minimal_actions"])
            self.action_set_size = len(self.minimal_set)
            if self.minimal_set != tuple(range(18)):
                self._action_map = torch.tensor(self.minimal_set, device=device)
            if preset["lives"] >= 0:
                self.lives_addr = int(preset["lives"])
        self._swcha = torch.tensor(_SWCHA, dtype=torch.int32, device=device)
        self._inpt4 = torch.tensor(_INPT4, dtype=torch.int32, device=device)

    def init(self, draw):
        # Console power-on is deterministic.
        return tia.attach_tia(
            cpu6502.make_machine(self.rom_np, draw.shape[0], self.device)
        )

    def inputs(self, action: torch.Tensor):
        """(SWCHA, INPT4) int32 ``[N]`` of the game's action indices."""
        action = action.long()
        # Presets with a minimal action set receive core indices; map them
        # back to ALE ids before decoding joystick components.
        if self._action_map is not None:
            n = len(self.minimal_set)
            action = self._action_map[torch.clamp(action, 0, n - 1)]
        ale = torch.clamp(action, 0, 17)
        return self._swcha[ale], self._inpt4[ale]

    def tick(self, g, action, draw):
        del draw
        swcha, inpt4 = self.inputs(action)
        g = {**g, "swcha": swcha, "inpt4": inpt4}
        prev_score = self._score(g)
        g = machine_frame(g, self.tables)
        reward = self._score(g) - prev_score
        return g, reward, self.over(g)

    def _decode(self, g, addrs, mode: str) -> torch.Tensor:
        """Multi-byte score decode, least-significant byte first.

        ``bcd``: two packed decimal digits per byte (ALE's getDecimalScore
        convention); ``raw``: base-256 binary.
        """
        total = torch.zeros_like(g["pc"])
        base = 1
        for off in addrs:
            b = g["ram"][:, off & 0x7F]
            if mode == "bcd":
                total = total + ((b >> 4) * 10 + (b & 0xF)) * base
                base *= 100
            else:
                total = total + b * base
                base *= 256
        return total

    def _score(self, g) -> torch.Tensor:
        """float32 score whose per-frame difference is the reward."""
        if self.preset is not None and self.preset["score"]:
            p = self.preset
            score = self._decode(g, p["score"], p["mode"]) * p["mult"]
            if p["opponent_score"] >= 0:
                score = score - self._decode(
                    g, (p["opponent_score"],), p["mode"]
                ) * p["mult"]
            return score.to(torch.float32)
        if self.reward_addr < 0:
            return torch.zeros(g["pc"].shape, dtype=torch.float32, device=self.device)
        return g["ram"][:, self.reward_addr & 0x7F].to(torch.float32)

    def lives(self, g):
        if self.lives_addr < 0:
            return torch.ones_like(g["pc"])
        mask = self.preset["lives_mask"] if self.preset is not None else 0xFF
        return g["ram"][:, self.lives_addr & 0x7F] & mask

    def over(self, g):
        if self.lives_addr < 0:
            return torch.zeros(g["pc"].shape, dtype=torch.bool, device=self.device)
        return self.lives(g) <= 0

    def ram(self, g):
        return g["ram"].to(torch.uint8)

    def render_gray(self, g):
        frame = tia.render_frame(g["lines"]).to(torch.float32)
        # 160x192 TIA frame → the 210x160 raw-pipeline canvas (letterboxed).
        canvas = torch.zeros(
            (frame.shape[0], RAW_H, RAW_W), dtype=torch.float32, device=self.device
        )
        canvas[:, 9:201] = frame
        return canvas

    def render_rgb(self, g):
        gray = self.render_gray(g)
        return torch.stack([gray, gray, gray], dim=1)


class Machine2600Env(ArcadeEnv):
    """ArcadeEnv over a user-supplied ROM (``rom_path`` make-kwarg).

    With ``game="breakout"`` (etc., :mod:`rom_presets`) the pool gets
    per-ROM reward/lives/terminal semantics and the game's ALE minimal
    action set; the ``Machine2600/{Game}-v5`` ids preset this.
    ``instructions_per_frame`` is accepted and unused, as in the JAX env:
    the line structure bounds the work.
    """

    DEFAULT_CONFIG = {
        **ArcadeEnv.DEFAULT_CONFIG,
        "rom_path": "",
        "instructions_per_frame": 4000,
        "ram_reward_addr": -1,
        "ram_lives_addr": -1,
        "game": "",
    }

    def __init__(self, config):
        rom_path = str(config["rom_path"])
        if not rom_path:
            raise ValueError(
                "Machine2600 needs rom_path= pointing at a cartridge ROM "
                "(no ROM assets ship with the package)"
            )
        rom = np.fromfile(rom_path, np.uint8)
        if rom.size not in (2048, 4096, 8192, 16384):
            raise ValueError(
                f"{rom_path}: expected a 2K/4K/8K(F8)/16K(F6) cartridge, "
                f"got {rom.size} B"
            )
        if rom.size == 2048:
            rom = np.tile(rom, 2)  # 2K carts mirror into 4K
        self._rom = rom
        self._preset = None
        if str(config["game"]):
            from .rom_presets import get_preset

            self._preset = get_preset(str(config["game"]))
        super().__init__(config)

    def _make_game(self) -> Machine2600Game:
        return Machine2600Game(
            self.device,
            self._rom,
            int(self.config["ram_reward_addr"]),
            int(self.config["ram_lives_addr"]),
            self._preset,
        )
