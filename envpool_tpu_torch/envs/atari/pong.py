"""Pong — batched arcade game core.

Counterpart of ``envpool_tpu/envs/atari/pong.py``, written over ``[N]``
tensors instead of one env under ``vmap``.  The float arithmetic follows
the JAX core operation by operation, so game state, reward and frames are
bit-exact against it.  The serve speed comes from an integer draw in
``[0, 4)`` that indexes ``_SERVE_VY`` (JAX: ``jax.random.choice``).
"""

from __future__ import annotations

import torch

from ...core.env import tree_where
from .arcade_env import RAW_H, RAW_W, ArcadeEnv, ArcadeGame

# Playfield geometry (screen rows).
_TOP = 34
_BOT = 194
_PADDLE_H = 16.0
_PLAYER_X = 140  # player paddle columns [140, 144)
_CPU_X = 16
_PADDLE_W = 4
_BALL = 2
_PLAYER_SPEED = 4.0
_CPU_SPEED = 2.0
_SERVE_FRAMES = 40
_MAX_SCORE = 21
_SERVE_VY = (-1.0, -0.5, 0.5, 1.0)

# Luma values of the ALE Pong palette (bg (144,72,17), player (92,186,92),
# cpu (213,130,74), ball (236,236,236)).
_BG = 87.0
_PLAYER_L = 147.0
_CPU_L = 148.0
_BALL_L = 236.0
_BAND_L = 236.0

_RGB = {
    "bg": (144.0, 72.0, 17.0),
    "player": (92.0, 186.0, 92.0),
    "cpu": (213.0, 130.0, 74.0),
    "ball": (236.0, 236.0, 236.0),
}


class PongGame(ArcadeGame):
    action_set_size = 6
    has_fire = True
    minimal_set = (0, 1, 3, 4, 11, 12)  # NOOP FIRE RIGHT LEFT R-FIRE L-FIRE
    supported_difficulties = (0, 1)
    draw_n = len(_SERVE_VY)

    def __init__(self, device: torch.device):
        super().__init__(device)
        self._serve_table = torch.tensor(_SERVE_VY, device=device)
        self._rows = torch.arange(RAW_H, dtype=torch.float32, device=device)[
            None, :, None
        ]
        self._cols = torch.arange(RAW_W, dtype=torch.float32, device=device)[
            None, None, :
        ]

    def _player_h(self):
        # ALE difficulty switch: position 1 halves the player's paddle.
        return _PADDLE_H * (0.5 if self.difficulty == 1 else 1.0)

    def _serve_vy(self, draw: torch.Tensor) -> torch.Tensor:
        return self._serve_table[draw.long()]

    def init(self, draw):
        n = draw.shape[0]

        def full(v, dtype=torch.float32):
            return torch.full((n,), v, dtype=dtype, device=self.device)

        return {
            "ball_y": full(110.0),
            "ball_x": full(78.0),
            "vel_y": self._serve_vy(draw),
            "vel_x": full(-1.0),
            "player_y": full(110.0),
            "cpu_y": full(110.0),
            "score_p": full(0, torch.int32),
            "score_c": full(0, torch.int32),
            "serve_timer": full(_SERVE_FRAMES, torch.int32),
            "serve_dir": full(-1.0),
        }

    def over(self, g):
        return (g["score_p"] >= _MAX_SCORE) | (g["score_c"] >= _MAX_SCORE)

    def tick(self, g, action, draw):
        where = torch.where
        over0 = self.over(g)
        # Player paddle: UP on actions 2/4, DOWN on 3/5.
        up = (action == 2) | (action == 4)
        down = (action == 3) | (action == 5)
        dy = where(up, -_PLAYER_SPEED, where(down, _PLAYER_SPEED, 0.0))
        ph = self._player_h()
        player_y = torch.clamp(g["player_y"] + dy, _TOP, _BOT - ph)

        # CPU paddle tracks the ball (only when the ball approaches it).
        target = g["ball_y"] + _BALL / 2 - _PADDLE_H / 2
        toward = g["vel_x"] < 0
        speed = where(toward, _CPU_SPEED, 1.0)
        delta = torch.minimum(torch.maximum(target - g["cpu_y"], -speed), speed)
        cpu_y = torch.clamp(g["cpu_y"] + delta, _TOP, _BOT - _PADDLE_H)

        serving = g["serve_timer"] > 0
        serve_timer = torch.clamp(g["serve_timer"] - 1, min=0)
        serve_now = serving & (serve_timer == 0)

        # Ball motion (frozen while serving).
        by = g["ball_y"] + where(serving, 0.0, g["vel_y"])
        bx = g["ball_x"] + where(serving, 0.0, g["vel_x"])
        vy = g["vel_y"]
        vx = g["vel_x"]

        # Wall bounce.
        hit_top = by < _TOP
        hit_bot = by > _BOT - _BALL
        by = torch.clamp(by, _TOP, _BOT - _BALL)
        vy = where(hit_top | hit_bot, -vy, vy)

        # Paddle bounces with "english" from the contact point.
        def paddle_hit(bx, by, vx, vy, px, py, moving_right, h=_PADDLE_H):
            over_col = (
                (bx + _BALL >= px) & (bx <= px + _PADDLE_W)
                if moving_right
                else (bx <= px + _PADDLE_W) & (bx + _BALL >= px)
            )
            overlap = (by + _BALL >= py) & (by <= py + h)
            going = (vx > 0) if moving_right else (vx < 0)
            hit = over_col & overlap & going
            english = (by + _BALL / 2 - (py + h / 2)) * 0.25
            new_speed = torch.clamp(torch.abs(vx) + 0.25, max=2.5)
            vx = where(hit, -new_speed if moving_right else new_speed, vx)
            vy = where(hit, torch.clamp(vy + english, -2.0, 2.0), vy)
            return vx, vy

        vx, vy = paddle_hit(
            bx, by, vx, vy, float(_PLAYER_X), player_y, True, ph
        )
        vx, vy = paddle_hit(bx, by, vx, vy, float(_CPU_X), cpu_y, False)

        # Scoring.
        p_scores = bx < 0
        c_scores = bx > RAW_W - _BALL
        scored = p_scores | c_scores
        reward = where(p_scores, 1.0, where(c_scores, -1.0, 0.0))
        score_p = g["score_p"] + p_scores.to(torch.int32)
        score_c = g["score_c"] + c_scores.to(torch.int32)
        serve_timer = where(scored, _SERVE_FRAMES, serve_timer)
        serve_dir = where(p_scores, -1.0, where(c_scores, 1.0, g["serve_dir"]))
        by = where(scored, 110.0, by)
        bx = where(scored, 78.0, bx)

        # Serve launch.
        vy = where(serve_now, self._serve_vy(draw), vy)
        vx = where(serve_now, serve_dir * 1.0, vx)

        new_g = {
            "ball_y": by,
            "ball_x": bx,
            "vel_y": vy,
            "vel_x": vx,
            "player_y": player_y,
            "cpu_y": cpu_y,
            "score_p": score_p,
            "score_c": score_c,
            "serve_timer": serve_timer.to(torch.int32),
            "serve_dir": serve_dir.to(torch.float32),
        }
        # Freeze everything once the game is over.
        new_g = tree_where(over0, g, new_g)
        reward = where(over0, 0.0, reward).to(torch.float32)
        return new_g, reward, self.over(new_g)

    # -- rendering ---------------------------------------------------------

    def _masks(self, g):
        rows, cols = self._rows, self._cols

        def col(v):
            return v[:, None, None]

        band = (rows < _TOP) | (rows >= _BOT)
        player = (
            (cols >= _PLAYER_X)
            & (cols < _PLAYER_X + _PADDLE_W)
            & (rows >= col(g["player_y"]))
            & (rows < col(g["player_y"] + self._player_h()))
        )
        cpu = (
            (cols >= _CPU_X)
            & (cols < _CPU_X + _PADDLE_W)
            & (rows >= col(g["cpu_y"]))
            & (rows < col(g["cpu_y"] + _PADDLE_H))
        )
        ball = (
            col(g["serve_timer"] == 0)
            & (cols >= col(g["ball_x"]))
            & (cols < col(g["ball_x"] + _BALL))
            & (rows >= col(g["ball_y"]))
            & (rows < col(g["ball_y"] + _BALL))
        )
        return band, player, cpu, ball

    def _paint(self, masks, colors):
        band, player, cpu, ball = masks
        n = player.shape[0]
        frame = torch.full(
            (n, RAW_H, RAW_W), colors[0], dtype=torch.float32, device=self.device
        )
        for mask, value in zip((band, player, cpu, ball), colors[1:]):
            frame = torch.where(mask, value, frame)
        return frame

    def render_gray(self, g):
        return self._paint(
            self._masks(g), (_BG, _BAND_L, _PLAYER_L, _CPU_L, _BALL_L)
        )

    def render_rgb(self, g):
        masks = self._masks(g)
        return torch.stack(
            [
                self._paint(
                    masks,
                    (
                        _RGB["bg"][c],
                        _RGB["ball"][c],
                        _RGB["player"][c],
                        _RGB["cpu"][c],
                        _RGB["ball"][c],
                    ),
                )
                for c in range(3)
            ],
            dim=1,
        )

    def ram(self, g):
        n = g["score_c"].shape[0]
        ram = torch.zeros((n, 128), dtype=torch.uint8, device=self.device)

        def byte(v):
            return torch.clamp(v, 0, 255).to(torch.uint8)

        ram[:, 13] = g["score_c"].to(torch.uint8)
        ram[:, 14] = g["score_p"].to(torch.uint8)
        ram[:, 49] = byte(g["ball_x"])
        ram[:, 54] = byte(g["ball_y"])
        ram[:, 50] = byte(g["cpu_y"])
        ram[:, 51] = byte(g["player_y"])
        return ram


class PongEnv(ArcadeEnv):
    GAME_CLS = PongGame
