"""The port's classic-control envs against the JAX package.

Both engines start from one JAX pool state (carried over by
``envpool_tpu_torch.interop``), and the port is handed the reset draws
the JAX envs make from their threefry keys (the key splits of
``engine.py:180`` and each env's ``reset_env``).  Every step starts the
port from JAX's state again, so each step is compared from the same
state: float fields agree to float32 rounding, within
``FLOAT32_TOL · (1 + |jax|)``; integer and bool fields are equal, except a
done flag whose state lies within that tolerance of its threshold.

The helpers here (``EnginePair``, ``jax_draws``) also serve
``tests/test_torch_mujoco_gym.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu.core.engine import Engine as JaxEngine
from envpool_tpu.core.engine import PoolState as JaxPoolState
from envpool_tpu.core.registry import registry as jax_registry
from envpool_tpu_torch import interop
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.core.registry import registry as torch_registry

# Float32 agreement of one step: a few units in the last place of values
# of order one (XLA's and torch's sin/cos may differ by an ulp or two).
FLOAT32_TOL = 2e-6


def _uniform(key, shape, lo, hi):
    return jax.random.uniform(key, shape, jnp.float32, lo, hi)


def _split2(key):
    return jax.random.split(key)


# JAX's reset draws of each env class from the env's reset subkey, in the
# port's draw layout.
_RESET_DRAWS = {
    "CartPoleEnv": lambda sub: {"state": _uniform(sub, (4,), -0.05, 0.05)},
    "PendulumEnv": lambda sub: {
        "theta": _uniform(_split2(sub)[0], (), -math.pi, math.pi),
        "theta_dot": _uniform(_split2(sub)[1], (), -1.0, 1.0),
    },
    "AcrobotEnv": lambda sub: {"state": _uniform(sub, (4,), -0.1, 0.1)},
    "MountainCarEnv": lambda sub: {"pos": _uniform(sub, (), -0.6, -0.4)},
    "MountainCarContinuousEnv": lambda sub: {
        "pos": _uniform(sub, (), -0.6, -0.4)
    },
}


def jax_draws(one_reset):
    """Batched JAX reset draws from pool keys: ``keys -> {name: tensor}``."""

    def one(key):
        _, sub = jax.random.split(key)
        return one_reset(sub)

    fn = jax.jit(jax.vmap(one))

    def draws(keys):
        out = jax.device_get(fn(jnp.asarray(keys)))
        return {k: torch.as_tensor(np.array(v)) for k, v in out.items()}

    return draws


def host(ps):
    return dataclasses.asdict(jax.device_get(ps))


def to_jax(tree):
    return JaxPoolState(**jax.tree_util.tree_map(jnp.asarray, tree))


class EnginePair:
    """A JAX engine and a port engine over the same task and config."""

    def __init__(self, task, n, reset_draws, **cfg):
        jenv = envpool_tpu.make_spec(task, num_envs=n, seed=3, **cfg).env
        self.jeng = JaxEngine(jenv)
        self.tenv = envpool_tpu_torch.make_spec(
            task, num_envs=n, seed=3, device="cpu", **cfg
        ).env
        self.teng = Engine(self.tenv)
        self.draws = jax_draws(reset_draws)

    def step(self, tree, action):
        """One step of both engines from the host pool state ``tree``:
        ``(jax tree after, jax timestep, port timestep)``."""
        draws = self.draws(tree["key"])
        self.tenv.reset_draws = lambda sub: draws
        jps, jts = self.jeng.step(to_jax(tree), {"action": jnp.asarray(action)})
        tps = interop.pool_state_from_numpy(tree, "cpu")
        _, tts = self.teng.step(tps, {"action": torch.as_tensor(action)})
        return host(jps), jax.device_get(jts), tts


def assert_ts_close(jts, tts, tol, margin=None):
    """Timesteps equal key for key: float fields within ``tol·(1 + |jax|)``,
    the rest exactly, except done flags where ``margin`` (the new state's
    distance to termination, ``[N]``) is below ``tol``."""
    assert set(jts) == set(tts)
    for k, v in jts.items():
        v, got = np.asarray(v), tts[k].numpy()
        assert got.dtype == v.dtype, k
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_array_less(
                np.abs(got - v), tol * (1 + np.abs(v)) + 1e-30, err_msg=k
            )
        elif k in ("done", "step_type") and margin is not None:
            rows = (got != v).reshape(len(v), -1).any(1)
            assert (margin[rows] < tol).all(), f"{k} differs away from a threshold"
        else:
            np.testing.assert_array_equal(got, v, err_msg=k)


def _cartpole_margin(s):
    return np.minimum(
        np.abs(np.abs(s[:, 0]) - 2.4), np.abs(np.abs(s[:, 2]) - 12 * 2 * math.pi / 360)
    )


def _acrobot_margin(s):
    return np.abs(-np.cos(s[:, 0]) - np.cos(s[:, 0] + s[:, 1]) - 1)


def _mountain_margin(goal):
    return lambda s: np.minimum(np.abs(s[:, 0] - goal), np.abs(s[:, 1]))


# task -> (env class, termination margin of a state, a state that
# terminates soon, action sampler)
_TASKS = {
    "CartPole-v0": ("CartPoleEnv", _cartpole_margin, [2.35, 1.5, 0.0, 0.0]),
    "CartPole-v1": ("CartPoleEnv", _cartpole_margin, [0.0, 0.0, 0.2, 1.0]),
    "Pendulum-v0": ("PendulumEnv", None, [3.1, 7.9]),
    "Pendulum-v1": ("PendulumEnv", None, [-3.1, -7.9]),
    "Acrobot-v1": ("AcrobotEnv", _acrobot_margin, [2.9, 0.2, 3.0, 0.0]),
    "MountainCar-v0": ("MountainCarEnv", _mountain_margin(0.5), [0.49, 0.05]),
    "MountainCarContinuous-v0": (
        "MountainCarContinuousEnv",
        _mountain_margin(0.45),
        [0.44, 0.05],
    ),
}


def _actions(spec, steps, n, seed):
    r = np.random.default_rng(seed)
    if spec.is_discrete:
        return r.integers(0, spec.maximum + 1, (steps, n)).astype(np.int32)
    # Continuous actions reach outside the bounds, which the envs clip.
    return r.uniform(-2.5, 2.5, (steps, n, *spec.shape)).astype(np.float32)


@pytest.mark.parametrize("task", sorted(_TASKS))
def test_step_matches_jax_across_auto_reset(task):
    cls, margin, near_end = _TASKS[task]
    n, steps = 5, 9
    pair = EnginePair(task, n, _RESET_DRAWS[cls], max_episode_steps=6)
    zero = pair.tenv.action_spec()["action"]
    acts = _actions(zero, steps + 1, n, seed=len(task))
    tree = host(pair.jeng.step(pair.jeng.init(), {"action": jnp.asarray(acts[0])})[0])
    # Env 0 starts next to a termination (for the envs that terminate).
    tree["env_state"][0] = np.asarray(near_end, np.float32)
    seen = {"terminated": 0, "truncated": 0, "reset": 0}
    for t in range(1, steps + 1):
        tree, jts, tts = pair.step(tree, acts[t])
        state = tree["env_state"]
        assert_ts_close(jts, tts, FLOAT32_TOL, None if margin is None else margin(state))
        done, trunc = jts["done"], jts["trunc"]
        seen["terminated"] += int((done & ~trunc).sum())
        seen["truncated"] += int(trunc.sum())
        seen["reset"] += int((jts["step_type"] == 0).sum())
    assert seen["truncated"] >= 1 and seen["reset"] >= 1
    assert margin is None or seen["terminated"] >= 1


@pytest.mark.parametrize(
    "task, keys",
    [
        ("CartPole-v1", {"state": (-0.05, 0.05, (4,))}),
        ("Acrobot-v1", {"state": (-0.1, 0.1, (4,))}),
        ("Pendulum-v1", {"theta": (-math.pi, math.pi, ()), "theta_dot": (-1.0, 1.0, ())}),
        ("MountainCar-v0", {"pos": (-0.6, -0.4, ())}),
    ],
)
def test_reset_draws_range_and_distribution(task, keys):
    env = envpool_tpu_torch.make_spec(task, device="cpu").env
    _, sub = rng.split(rng.seed_keys(np.arange(20000), torch.device("cpu")))
    draws = env.reset_draws(sub)
    assert set(draws) == set(keys)
    for k, (lo, hi, shape) in keys.items():
        d = draws[k].numpy()
        assert d.shape == (20000, *shape) and d.dtype == np.float32
        assert lo <= d.min() and d.max() < hi
        # Uniform: each tenth of the range within 5 sigma of its count.
        counts = np.histogram(d, bins=10, range=(lo, hi))[0]
        expect = d.size / 10
        assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect)), k
    # Per-env streams: another subkey gives other draws.
    _, sub2 = rng.split(rng.split(rng.seed_keys(np.arange(20000), torch.device("cpu")))[0])
    k = next(iter(keys))
    assert float((env.reset_draws(sub2)[k] == draws[k]).float().mean()) < 0.01


@pytest.mark.parametrize(
    "task_id",
    [t for t, (path, _, _) in jax_registry.specs.items() if path.endswith("classic_control")],
)
def test_registration_matches_jax(task_id):
    _, jcls, jkw = jax_registry.specs[task_id]
    path, tcls, tkw = torch_registry.specs[task_id]
    assert path == "envpool_tpu_torch.envs.classic_control"
    assert (tcls, tkw) == (jcls, jkw)
    jspec = envpool_tpu.make_spec(task_id)
    tspec = envpool_tpu_torch.make_spec(task_id, device="cpu")
    assert tspec.reward_threshold == jspec.reward_threshold
    assert tspec.config.max_episode_steps == jspec.config.max_episode_steps
    for k, js in jspec.state_array_spec.items():
        ts = tspec.state_array_spec[k]
        assert (ts.shape, ts.dtype) == (js.shape, js.dtype), k
        np.testing.assert_allclose(ts.minimum, js.minimum, rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(ts.maximum, js.maximum, rtol=1e-6, err_msg=k)
    assert set(tspec.state_array_spec) == set(jspec.state_array_spec)
    assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec)


def test_gymnasium_dm_and_functional_pools_run_cartpole():
    n = 6
    pool = envpool_tpu_torch.make("CartPole-v1", env_type="gymnasium", num_envs=n, device="cpu")
    obs, _ = pool.reset()
    assert obs.shape == (n, 4) and np.abs(obs).max() <= 0.05
    steps = 0
    for steps in range(1, 200):
        obs, rew, term, trunc, info = pool.step(np.ones(n, np.int32))
        assert (rew == 1).all()
        if term.any():
            break
    assert term.any() and steps < 100  # pushing right always topples the pole
    dm = envpool_tpu_torch.make_dm("CartPole-v1", num_envs=n, device="cpu")
    ts = dm.reset()
    ts = dm.step(np.zeros(n, np.int32))
    assert (ts.step_type == 1).all() and ts.observation.obs.shape == (n, 4)
    handle, recv, send, step = pool.xla()
    handle, (obs, rew, term, trunc, info) = step(handle, torch.zeros(n, dtype=torch.int32))
    assert tuple(obs.shape) == (n, 4)
    frames = pool.spec.env.render_state(pool.pool_state.env_state)
    assert frames.shape == (n, 400, 600, 3) and frames.dtype == torch.uint8


def test_make_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        envpool_tpu_torch.make("CartPole-v1", env_type="gymnasium")


def test_uniform_blocks_match_single_draws():
    _, sub = rng.split(rng.seed_keys(np.arange(50), torch.device("cpu")))
    block = rng.uniform(sub, 3, 4)
    for i in range(4):
        assert torch.equal(block[:, i], rng.uniform(sub, 3 + i))
