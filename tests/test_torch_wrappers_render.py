"""The port's wrappers, ``render``, ``record_dir`` and ``save_state`` /
``load_state`` against the JAX package.

Mirrors ``tests/test_wrappers.py``, ``tests/test_render.py`` and
``tests/test_record.py`` for the port, and holds each wrapper's steps to
the JAX wrapper's from the same states and draws (float fields within
``FLOAT32_TOL · (1 + |jax|)``, the classic-control tests' bar), and
CartPole's and PongLite's rendered frames to JAX's, equal.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu import wrappers as jwrappers
from envpool_tpu.core.engine import Engine as JaxEngine
from envpool_tpu.envs import classic_control as jcc
from envpool_tpu_torch import interop, wrappers
from envpool_tpu_torch.adapters.base import tile_frames
from envpool_tpu_torch.adapters.gymnasium_adapter import GymnasiumEnvPool
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.core.env_spec import EnvSpec
from envpool_tpu_torch.envs.classic_control import CartPoleEnv, PendulumEnv
from test_torch_classic import FLOAT32_TOL, _RESET_DRAWS, assert_ts_close, host, jax_draws, to_jax

# -- wrappers: the JAX tests, mirrored ------------------------------------------


def _engine(env, n):
    eng = Engine(env)
    ps, ts = eng.reset(eng.init(), torch.ones(n, dtype=torch.bool))
    return eng, ps, ts


def test_frame_stack_spec_and_shift():
    env = wrappers.FrameStack(CartPoleEnv.from_config(num_envs=4, device="cpu"), stack_num=3)
    assert env.state_spec()["obs"].shape == (3, 4)
    eng, ps, ts = _engine(env, 4)
    obs0 = ts["obs"].numpy()
    np.testing.assert_array_equal(obs0[:, 0], obs0[:, 1])  # push_all at reset
    np.testing.assert_array_equal(obs0[:, 1], obs0[:, 2])
    ps, ts = eng.step(ps, {"action": torch.ones(4, dtype=torch.int32)})
    obs1 = ts["obs"].numpy()
    np.testing.assert_array_equal(obs1[:, 0], obs0[:, 2])
    np.testing.assert_array_equal(obs1[:, 1], obs0[:, 2])
    assert not np.array_equal(obs1[:, 2], obs0[:, 2])


def test_reward_clip():
    env = wrappers.RewardClip(PendulumEnv.from_config(num_envs=2, device="cpu"))
    assert "info:reward" in env.state_spec()
    eng, ps, ts = _engine(env, 2)
    assert ts["info:reward"].tolist() == [0.0, 0.0]
    ps, ts = eng.step(ps, {"action": torch.zeros(2, 1)})
    assert set(ts["reward"].unique().tolist()) <= {-1.0, 0.0}
    assert (ts["info:reward"] <= 0).all() and (ts["info:reward"] != ts["reward"]).any()


def test_transform_observation_and_reward():
    env = wrappers.TransformObservation(
        CartPoleEnv.from_config(num_envs=2, device="cpu"), lambda o: o * 2.0)
    _, _, ts = _engine(env, 2)
    assert float(ts["obs"].abs().max()) <= 0.1  # 2 * 0.05
    env = wrappers.TransformReward(CartPoleEnv.from_config(num_envs=2, device="cpu"),
                                   lambda r: r * 3)
    eng, ps, _ = _engine(env, 2)
    _, ts = eng.step(ps, {"action": torch.ones(2, dtype=torch.int32)})
    assert ts["reward"].tolist() == [3.0, 3.0] and ts["reward"].dtype == torch.float32


def test_normalize_obs_converges():
    env = wrappers.NormalizeObs(PendulumEnv.from_config(num_envs=4, device="cpu"))
    eng, ps, ts = _engine(env, 4)
    for _ in range(50):
        ps, ts = eng.step(ps, {"action": torch.zeros(4, 1)})
    obs = ts["obs"].numpy()
    assert np.abs(obs).max() <= 10.0  # clipped
    assert np.abs(obs).mean() < 3.0  # O(1), not the raw scale
    assert ps.env_state["stats"]["count"].tolist() == [51.0] * 4


# -- wrappers against JAX -----------------------------------------------------


def _jax_state_to_port(tree):
    """JAX's NormalizeObs keeps ``(count, mean, m2)``, the port a dict."""
    st = tree["env_state"]
    if "stats" in st:
        count, mean, m2 = st["stats"]
        st = dict(st, stats={"count": count, "mean": mean, "m2": m2})
    return dict(tree, env_state=st)


WRAPPED = {
    "FrameStack": (lambda w, e: w.FrameStack(e, stack_num=3), "CartPoleEnv", jcc.CartPoleEnv,
                   CartPoleEnv),
    "NormalizeObs": (lambda w, e: w.NormalizeObs(e), "PendulumEnv", jcc.PendulumEnv,
                     PendulumEnv),
    "RewardClip": (lambda w, e: w.RewardClip(e), "PendulumEnv", jcc.PendulumEnv, PendulumEnv),
}


@pytest.mark.parametrize("name", sorted(WRAPPED))
def test_wrapper_steps_match_jax(name):
    """Eight steps of five wrapped envs from JAX's states, episodes cut at
    three steps (the reset branch of NormalizeObs keeps its statistics)."""
    wrap, draws_of, jcls, tcls = WRAPPED[name]
    n, steps = 5, 8
    jenv = wrap(jwrappers, jcls.from_config(num_envs=n, seed=3, max_episode_steps=3))
    tenv = wrap(wrappers, tcls.from_config(num_envs=n, seed=3, max_episode_steps=3,
                                           device="cpu"))
    jeng, teng = JaxEngine(jenv), Engine(tenv)
    draws = jax_draws(_RESET_DRAWS[draws_of])
    r = np.random.default_rng(1)
    acts = (r.integers(0, 2, (steps + 1, n)).astype(np.int32) if draws_of == "CartPoleEnv"
            else r.uniform(-2, 2, (steps + 1, n, 1)).astype(np.float32))
    tree = host(jeng.step(jeng.init(), {"action": jnp.asarray(acts[0])})[0])
    for t in range(1, steps + 1):
        d = draws(tree["key"])
        tenv.inner.reset_draws = lambda sub: d
        jps, jts = jeng.step(to_jax(tree), {"action": jnp.asarray(acts[t])})
        tps = interop.pool_state_from_numpy(_jax_state_to_port(tree), "cpu")
        _, tts = teng.step(tps, {"action": torch.as_tensor(acts[t])})
        tree = host(jps)
        assert_ts_close(jax.device_get(jts), tts, FLOAT32_TOL)


# -- render ---------------------------------------------------------------------


def _pair_pools(task, n, states=None):
    """A JAX pool and a port pool of ``task`` holding the same state."""
    jpool = envpool_tpu.make(task, env_type="gymnasium", num_envs=n, seed=0)
    jpool.reset()
    if states is not None:
        jpool._state = dataclasses.replace(jpool._state, env_state=jnp.asarray(states))
    tpool = envpool_tpu_torch.make(task, env_type="gymnasium", num_envs=n, seed=0,
                                   device="cpu")
    tpool._state = interop.pool_state_from_numpy(host(jpool.pool_state), "cpu")
    return jpool, tpool


def test_cartpole_render_matches_jax():
    states = np.array([[0.0, 0, 0.0, 0], [1.3, 0, 0.2, 0], [-2.2, 0, -0.21, 0],
                       [0.37, 0, 1.0, 0], [-0.11, 0, -2.5, 0], [2.39, 0, 3.1, 0]], np.float32)
    jpool, tpool = _pair_pools("CartPole-v1", 6, states)
    want, got = jpool.render(), tpool.render()
    assert got.shape == (6, 400, 600, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got == 255).mean() > 0.5 and (got == 0).any()
    assert (got == np.array([202, 152, 101], np.uint8)).all(-1).any(axis=(1, 2)).all()
    sub = tpool.render(np.array([1, 3]))
    assert sub.shape == (2, 400, 600, 3)
    np.testing.assert_array_equal(sub[1], got[3])


def test_pong_render_matches_jax():
    jpool, tpool = _pair_pools("PongLite-v5", 2)
    for _ in range(3):  # paddles and ball away from their start
        jpool.step(np.array([2, 5], np.int32))
    tpool._state = interop.pool_state_from_numpy(host(jpool.pool_state), "cpu")
    want, got = jpool.render(), tpool.render()
    assert got.shape == (2, 210, 160, 3)
    np.testing.assert_array_equal(got, want)
    assert (got == np.array([144, 72, 17], np.uint8)).all(-1).mean() > 0.5  # background


def test_render_unsupported_raises():
    env = envpool_tpu_torch.make("NChain-v0", env_type="gymnasium", num_envs=2, device="cpu")
    env.reset()
    with pytest.raises(NotImplementedError, match="NChainEnv does not support render"):
        env.render()


def test_tile_frames_grid():
    frames = np.arange(5 * 2 * 3 * 3, dtype=np.uint8).reshape(5, 2, 3, 3)
    grid = tile_frames(frames)
    assert grid.shape == (4, 9, 3)  # 5 frames: 3 columns x 2 rows
    assert (grid[0:2, 0:3] == frames[0]).all()
    assert (grid[0:2, 3:6] == frames[1]).all()
    assert (grid[2:4, 0:3] == frames[3]).all()
    assert (grid[2:4, 6:9] == 0).all()  # the empty cell
    from envpool_tpu.adapters.base import tile_frames as jax_tile_frames

    np.testing.assert_array_equal(grid, jax_tile_frames(frames))


def test_render_mode_human_requires_cv2():
    env = envpool_tpu_torch.make_gymnasium("CartPole-v1", num_envs=2, render_mode="human",
                                           device="cpu")
    env.reset()
    assert env.render_mode == "human"
    try:
        import cv2
    except ImportError:
        with pytest.raises(RuntimeError, match="opencv"):
            env.render()
        return
    shown = {}
    orig_imshow, orig_waitkey = cv2.imshow, cv2.waitKey
    cv2.imshow = lambda name, img: shown.update(name=name, img=img)
    cv2.waitKey = lambda ms: 0
    try:
        out = env.render()
    finally:
        cv2.imshow, cv2.waitKey = orig_imshow, orig_waitkey
    assert out is None
    assert shown["img"].shape == (400, 2 * 600, 3)


# -- record_dir -------------------------------------------------------------------


def test_record_and_replay(tmp_path):
    d = str(tmp_path / "demos")
    env = envpool_tpu_torch.make("CartPole-v1", env_type="gymnasium", num_envs=2, seed=9,
                                 max_episode_steps=40, record_dir=d, device="cpu")
    env.reset()
    rng = np.random.default_rng(3)
    sent, rewards, dones = [], [], 0
    for _ in range(60):
        a = rng.integers(0, 2, 2).astype(np.int32)
        sent.append(a)
        _, rew, term, trunc, _ = env.step(a)
        rewards.append(rew.copy())
        dones += int((term | trunc).sum())
    files = sorted(glob.glob(os.path.join(d, "*.npz")))
    assert len(files) == dones > 0
    with np.load(files[0]) as z:
        assert int(z["__seed__"]) in (9, 10)  # seed + env_id
        assert z["action"].ndim == 1 and len(z["action"]) > 0
    # Replaying the same actions through a fresh pool with the same seed
    # gives the same rewards (the port's own random streams).
    env2 = envpool_tpu_torch.make("CartPole-v1", env_type="gymnasium", num_envs=2, seed=9,
                                  max_episode_steps=40, device="cpu")
    env2.reset()
    for a, r in zip(sent, rewards):
        _, rew, *_ = env2.step(a)
        np.testing.assert_array_equal(rew, r)
    # Each file is one episode: its actions replay to a termination.
    with np.load(os.path.join(d, "env_0_0.npz")) as z:
        actions, eid = z["action"], int(z["__env_id__"])
    env3 = envpool_tpu_torch.make("CartPole-v1", env_type="gymnasium", num_envs=2, seed=9,
                                  max_episode_steps=40, device="cpu")
    env3.reset()
    for i, a in enumerate(actions):
        _, _, term, trunc, _ = env3.step(np.array([a, 0], np.int32))
        assert bool(term[eid] or trunc[eid]) == (i == len(actions) - 1)


# -- save_state / load_state ------------------------------------------------------


def test_save_load_round_trip(tmp_path):
    path = str(tmp_path / "pool.npz")
    env = envpool_tpu_torch.make("Ant-v4", env_type="gymnasium", num_envs=3, seed=2,
                                 device="cpu")
    env.reset()
    act = np.random.default_rng(0).uniform(-1, 1, (3, 8)).astype(np.float32)
    env.step(act)
    env.save_state(path)
    first = env.step(act)
    env.step(act)
    env.load_state(path)
    again = env.step(act)
    for a, b in zip(first[:4], again[:4]):
        np.testing.assert_array_equal(a, b)
    for k, v in first[4].items():
        if isinstance(v, dict):
            v, again[4][k] = v["env_id"], again[4][k]["env_id"]
        np.testing.assert_array_equal(v, again[4][k])


def test_load_state_mismatches_raise(tmp_path):
    path = str(tmp_path / "pool.npz")
    cart = envpool_tpu_torch.make("CartPole-v1", env_type="gymnasium", num_envs=2,
                                  device="cpu")
    cart.reset()
    cart.save_state(path)
    with pytest.raises(ValueError, match="leaf 0 mismatch — snapshot float32\\(2, 4\\) vs "
                                         "pool float32\\(3, 4\\)"):
        envpool_tpu_torch.make("CartPole-v1", env_type="gymnasium", num_envs=3,
                               device="cpu").load_state(path)
    with pytest.raises(ValueError, match="leaf 0 mismatch"):
        envpool_tpu_torch.make("Pendulum-v1", env_type="gymnasium", num_envs=2,
                               device="cpu").load_state(path)
    stacked = GymnasiumEnvPool(EnvSpec(wrappers.FrameStack(
        CartPoleEnv.from_config(num_envs=2, device="cpu"), stack_num=2)))
    with pytest.raises(ValueError, match="snapshot treedef does not match"):
        stacked.load_state(path)
    with np.load(path) as z:  # a snapshot without its structure, one leaf short
        np.savez(path, *(z[f"arr_{i}"] for i in range(len(z.files) - 2)))
    with pytest.raises(ValueError, match="snapshot has 4 leaves, pool state has 5"):
        cart.load_state(path)
