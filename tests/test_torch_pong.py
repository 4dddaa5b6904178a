"""The port's batched PongGame against the JAX PongGame, bit for bit.

Same states (drawn from a numpy seed), same actions and the same serve
draws go through JAX ``vmap(tick)`` and the port's batched ``tick``; state,
reward, game-over flag, gray and RGB frames and RAM must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envpool_tpu.envs.atari.pong import PongGame as JaxPong
from envpool_tpu_torch.envs.atari.pong import PongGame as TorchPong

N = 48


def _random_states(seed, n):
    rng = np.random.default_rng(seed)

    def quarter(lo, hi):
        return (np.floor(rng.uniform(lo, hi, n) * 4) / 4).astype(np.float32)

    return {
        "ball_y": quarter(30, 196),
        "ball_x": quarter(-3, 162),
        "vel_y": rng.choice([-2.0, -1.0, -0.5, 0.25, 0.5, 1.0, 1.75], n).astype(np.float32),
        "vel_x": rng.choice([-2.5, -1.25, -1.0, 1.0, 1.5, 2.5], n).astype(np.float32),
        "player_y": quarter(34, 178),
        "cpu_y": quarter(34, 178),
        "score_p": rng.choice([0, 5, 20, 21], n).astype(np.int32),
        "score_c": rng.choice([0, 7, 20], n).astype(np.int32),
        "serve_timer": rng.choice([0, 0, 0, 1, 2, 40], n).astype(np.int32),
        "serve_dir": rng.choice([-1.0, 1.0], n).astype(np.float32),
    }


def _jax_fns(game):
    tick = jax.jit(jax.vmap(game.tick))
    view = jax.jit(
        jax.vmap(lambda g: (game.render_gray(g), game.render_rgb(g), game.ram(g)))
    )
    draw = jax.jit(jax.vmap(lambda k: jax.random.randint(k, (), 0, 4)))
    return tick, view, draw


def _assert_game_equal(jg, tg):
    assert set(jg) == set(tg)
    for k in jg:
        np.testing.assert_array_equal(np.asarray(jg[k]), tg[k].numpy(), err_msg=k)


@pytest.mark.parametrize("difficulty", [0, 1])
def test_tick_render_ram_bit_exact(difficulty):
    jgame, tgame = JaxPong(), TorchPong(torch.device("cpu"))
    jgame.difficulty = tgame.difficulty = difficulty
    tick, view, draw = _jax_fns(jgame)
    states = _random_states(difficulty, N)
    jg = {k: jnp.asarray(v) for k, v in states.items()}
    tg = {k: torch.as_tensor(v) for k, v in states.items()}
    rng = np.random.default_rng(100 + difficulty)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(N))
    for t in range(24):
        actions = rng.integers(0, 6, N).astype(np.int32)
        keys = jax.vmap(lambda k: jax.random.fold_in(k, t))(keys)
        draws = np.asarray(draw(keys))
        jg, jr, jover = tick(jg, jnp.asarray(actions), keys)
        tg, tr, tover = tgame.tick(
            tg, torch.as_tensor(actions), torch.as_tensor(draws)
        )
        _assert_game_equal(jg, tg)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jover), tover.numpy())
        gray, rgb, ram = view(jg)
        np.testing.assert_array_equal(np.asarray(gray), tgame.render_gray(tg).numpy())
        np.testing.assert_array_equal(np.asarray(rgb), tgame.render_rgb(tg).numpy())
        np.testing.assert_array_equal(np.asarray(ram), tgame.ram(tg).numpy())


def test_init_and_over_match():
    jgame, tgame = JaxPong(), TorchPong(torch.device("cpu"))
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(16))
    jg = jax.vmap(jgame.init)(keys)
    # JAX init draws vel_y with choice(split(key)[0]); hand the port that index.
    idx = jax.vmap(
        lambda k: jax.random.randint(jax.random.split(k, 2)[0], (), 0, 4)
    )(keys)
    tg = tgame.init(torch.as_tensor(np.asarray(idx)))
    _assert_game_equal(jg, tg)
    states = _random_states(7, 16)
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(jgame.over)({k: jnp.asarray(v) for k, v in states.items()})),
        tgame.over({k: torch.as_tensor(v) for k, v in states.items()}).numpy(),
    )
